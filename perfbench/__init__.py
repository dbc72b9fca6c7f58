"""The benchmark of the PyTorch and CUDA renderer (`gltf_renderer_tpu_torch`).

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json and prints one JSON line.
Configurations (perfbench/configs/<name>.json), traffic mixes
(perfbench/traffic/<name>.json), per-layer metrics
(perfbench/metrics/<name>.py) and each cell's limits
(perfbench/limits/<cell>.json) are found by the names BENCHMARK.json gives.
"""
