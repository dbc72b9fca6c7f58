"""The warm-up launch made before anything is timed.

Port of bench.py's `_warm_pallas`: one tiny kernel launch, so that the CUDA
context, the kernel library load and the first launch are all paid before a
benchmark's clock starts.

- `add_one`, the wrapper: a CPU tensor goes to the plain version
  `warm_ref`; a CUDA tensor goes to the CUDA kernel (csrc/warm.cu), or the
  call raises.
- `warm(device)`: `add_one` over an (8, 128) f32 tile of zeros, synchronised,
  raising unless every value came back 1.
- `KERNEL_LAUNCHES`, a plain counter of kernel launches.
"""

from __future__ import annotations

import torch

from gltf_renderer_tpu_torch.device import resolve
from gltf_renderer_tpu_torch.ops import _build

WARM_SHAPE = (8, 128)

KERNEL_LAUNCHES = 0

_SOURCE = "warm.cu"
_ARGTYPES = [_build.VP, _build.VP, _build.CI, _build.VP]


def warm_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: x + 1."""
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 for an f32 tensor, through the kernel on a CUDA tensor."""
    global KERNEL_LAUNCHES
    if x.dtype != torch.float32:
        raise TypeError(f"add_one takes float32, got {x.dtype}")
    if x.is_cpu:
        return warm_ref(x)
    if not x.is_cuda:
        raise ValueError(f"add_one runs on cpu or cuda tensors, got {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    _build.launch(_build.entry(_SOURCE, "add_one_launch", _ARGTYPES), "add_one",
                  x.get_device(), x.data_ptr(), y.data_ptr(), x.numel())
    KERNEL_LAUNCHES += 1
    return y


def warm(device="cuda") -> torch.Tensor:
    """One warm-up launch on `device`; raises unless the result is all
    ones. Returns the (8, 128) result."""
    dev = resolve(device)
    y = add_one(torch.zeros(WARM_SHAPE, dtype=torch.float32, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if not bool((y == 1.0).all()):
        raise RuntimeError("warm-up kernel returned values other than 1")
    return y
