"""Build and load the port's CUDA kernels (plain C entry points, ctypes).

Each source under `csrc/` is compiled at first use with nvcc for Hopper
(`sm_90a`) into `build/torch_ext/`, named by a hash of the source and the
flags so an unchanged source is never rebuilt. No `--use_fast_math` and no
`-ftz=true`: the kernels keep IEEE division and denormals, and
`-fmad=false` keeps their rounding equal to the plain PyTorch versions'.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from gltf_renderer_tpu_torch.ops.bvh import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(source: str) -> str:
    """Path of the shared library built from csrc/<source>."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def load(source: str) -> ctypes.CDLL:
    """Compile csrc/<source> if its library is missing, then load it."""
    if source in _LOADED:
        return _LOADED[source]
    lib_path = library_path(source)
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    _LOADED[source] = lib
    return lib
