"""Where a kernel wrapper's launch spends host time, step by step, on one CUDA card.

    python -m gltf_renderer_tpu_torch.tools.bench_launch

Times on the host clock, 2,000 calls back to back each, every step of the
warm-up kernel's launch path (`ops.warm.add_one` on its 8x128 f32 tile)
alone, beside `torch.add(x, 1.0)` (the same function in one PyTorch call)
and the whole wrapper: the input and output tensors, torch's raw device
and stream getters that `ops._build.launch` reads, the stream query it does
not use (`torch.cuda.current_stream()`, which builds a Stream object), the
cached entry lookup, the C launcher with no work (ctypes and
`cudaGetLastError`) and with the launch, and `_build.launch`. The last line
is one JSON object {step: µs a call}.
"""

from __future__ import annotations

import json

import torch

from gltf_renderer_tpu_torch.device import card_name_and_power_limit, resolve
from gltf_renderer_tpu_torch.ops import _build
from gltf_renderer_tpu_torch.ops import warm
from gltf_renderer_tpu_torch.tools.bench_traverse import host_us


def main(device="cuda") -> dict:
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_launch times CUDA launches and needs a CUDA device")
    x = torch.randn(warm.WARM_SHAPE, generator=torch.Generator().manual_seed(3)).to(dev)
    fn = _build.entry("warm.cu", "add_one_launch", warm._ARGTYPES)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    idx = x.get_device()
    steps = {
        "torch.add(x, 1.0)": lambda: torch.add(x, 1.0),
        "warm.add_one(x)": lambda: warm.add_one(x),
        "x.contiguous()": x.contiguous,
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "torch._C._cuda_getDevice()": torch._C._cuda_getDevice,
        "torch._C._cuda_getCurrentRawStream(i)": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "_build.entry lookup": lambda: _build.entry("warm.cu", "add_one_launch", warm._ARGTYPES),
        "C launcher, n=0 (ctypes + cudaGetLastError)": lambda: fn(x.data_ptr(), y.data_ptr(), 0,
                                                                  stream),
        "C launcher, n=1024 (+ the launch)": lambda: fn(x.data_ptr(), y.data_ptr(), 1024, stream),
        "_build.launch(n=1024)": lambda: _build.launch(fn, "add_one", idx, x.data_ptr(),
                                                       y.data_ptr(), 1024),
    }
    out = {}
    for name, f in steps.items():
        out[name] = host_us(f)
        print(f"[launch] {name}: {out[name]:.3f} us a call (2000 calls)", flush=True)
    print(card_name_and_power_limit(), flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
