"""Hold a config 5 render (tools.render_config5's output directory) against
a reference image.

    python -m gltf_renderer_tpu_torch.tools.compare_config5 \
        [--out build/config5_torch] [--reference docs/artifacts/config5_courtyard.png]

Prints one JSON object: the checkpoint's spp and frame index, the NaN and
Inf counts of its accumulated HDR, and its PNG against the reference: SSIM
(utils.ssim over the u8 images, as the golden checks call it) and the
mean and largest absolute u8 difference. Runs on the host; it needs no
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from gltf_renderer_tpu_torch.tools import render_config5 as tool


def compare(out: str, reference: str) -> dict:
    from PIL import Image

    from gltf_renderer_tpu_torch.utils.ssim import ssim

    with np.load(os.path.join(out, tool.CKPT)) as ck:
        accum = ck["accum"]
        spp, frame_index = int(ck["accumulated_frames"]), int(ck["frame_index"])
    img = np.asarray(Image.open(os.path.join(out, tool.PNG)).convert("RGB"))
    ref = np.asarray(Image.open(reference).convert("RGB"))
    diff = np.abs(img.astype(np.int16) - ref.astype(np.int16))
    return {"spp": spp, "frame_index": frame_index, "resolution": [img.shape[1], img.shape[0]],
            "hdr_nan": int(np.isnan(accum).sum()), "hdr_inf": int(np.isinf(accum).sum()),
            "ssim": ssim(img, ref), "mean_abs_u8": float(diff.mean()),
            "max_abs_u8": int(diff.max()), "reference": reference}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("build", "config5_torch"))
    p.add_argument("--reference", default=os.path.join("docs", "artifacts", tool.PNG))
    args = p.parse_args(argv)
    print(json.dumps(compare(args.out, args.reference)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
