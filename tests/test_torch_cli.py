"""The port's CLI (gltf_renderer_tpu_torch/app/cli.py) against the JAX
package's app/cli.py, on the box file written by the JAX writer, the port
with device="cpu".

- The path tracer (--spp 2) and the raster backend at 48x32, and debug
  output 11 (shading normals): the PNGs equal on at least 98% of pixels
  (path tracer) or 99.5% (raster), with the means within 1% / 0.1%, the
  renderers' CPU bars read on u8 (the tone map's last bits can turn a
  count);
- --frames 2: the same numbered files in both;
- exit codes: 2 without --gltf, 1 for a missing scene and for a bad
  environment map, as JAX's;
- --shard auto on the CPU's one device renders unsharded.
"""

import os

import numpy as np
import pytest
from PIL import Image

from gltf_renderer_tpu.app import cli as jcli
from gltf_renderer_tpu_torch.app import cli as pcli
from tests.scenes import write_box_gltf

W, H = 48, 32


def port_main(argv):
    return pcli.main(argv, device="cpu")


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return write_box_gltf(str(tmp_path_factory.mktemp("cli") / "box.gltf"))


def _png(path):
    img = np.asarray(Image.open(path))
    assert img.dtype == np.uint8 and img.shape == (H, W, 3)
    return img


RUNS = {
    "pathtracer": ["--spp", "2"],
    "rasterizer": ["--backend", "rasterizer"],
    "debug_output": ["--spp", "1", "--debug-output", "11"],
}


@pytest.mark.parametrize("run", list(RUNS))
def test_png_matches_jax(run, box, tmp_path):
    imgs = {}
    for name, main in (("jax", jcli.main), ("port", port_main)):
        out = str(tmp_path / f"{name}.png")
        assert main(["--gltf", box, "--width", str(W), "--height", str(H), "--output", out]
                    + RUNS[run]) == 0
        imgs[name] = _png(out).astype(np.float64)
    share, mean_rel = (0.995, 0.001) if run == "rasterizer" else (0.98, 0.01)
    got, want = imgs["port"], imgs["jax"]
    equal = (got == want).all(-1).mean()
    rel = abs(got.mean() - want.mean()) / want.mean()
    assert equal >= share and rel <= mean_rel, (equal, rel)
    assert got.std() > 0


def test_frame_sequence_naming(box, tmp_path):
    names = {}
    for name, main in (("jax", jcli.main), ("port", port_main)):
        d = tmp_path / name
        d.mkdir()
        assert main(["--gltf", box, "--width", str(W), "--height", str(H), "--spp", "1",
                     "--frames", "2", "--output", str(d / "seq.png")]) == 0
        names[name] = sorted(os.listdir(d))
        for f in names[name]:
            _png(str(d / f))
    assert names["port"] == names["jax"] == ["seq_0000.png", "seq_0001.png"]


def test_exit_codes_match_jax(box, tmp_path):
    bad = str(tmp_path / "bad.hdr")
    with open(bad, "wb") as f:
        f.write(b"not an hdr")
    out = str(tmp_path / "x.png")
    for argv, rc in ((["--output", out], 2),
                     (["--gltf", str(tmp_path / "nope.gltf"), "--output", out], 1),
                     (["--gltf", box, "--environment-map", bad, "--output", out], 1)):
        assert port_main(argv) == jcli.main(argv) == rc, argv
    assert not os.path.exists(out)


def test_shard_auto_on_one_device(box, tmp_path):
    out = str(tmp_path / "sh.png")
    assert port_main(["--gltf", box, "--width", str(W), "--height", str(H), "--spp", "1",
                      "--shard", "auto", "--output", out]) == 0
    _png(out)
