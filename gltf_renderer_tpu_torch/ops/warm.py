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

import ctypes

import torch

from gltf_renderer_tpu_torch.device import resolve

WARM_SHAPE = (8, 128)

KERNEL_LAUNCHES = 0

_SOURCE = "warm.cu"


def _kernel_library():
    from gltf_renderer_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    vp = ctypes.c_void_p
    lib.add_one_launch.argtypes = [vp, vp, ctypes.c_int, vp]
    lib.add_one_launch.restype = ctypes.c_int
    return lib


def warm_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: x + 1."""
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 for an f32 tensor, through the kernel on a CUDA tensor."""
    global KERNEL_LAUNCHES
    if x.dtype != torch.float32:
        raise TypeError(f"add_one takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return warm_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"add_one runs on cpu or cuda tensors, got {x.device}")
    lib = _kernel_library()
    x = x.contiguous()
    y = torch.empty_like(x)
    vp = ctypes.c_void_p
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.add_one_launch(vp(x.data_ptr()), vp(y.data_ptr()), x.numel(), vp(stream))
    if rc != 0:
        raise RuntimeError(f"add_one kernel launch failed: CUDA error {rc}")
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
