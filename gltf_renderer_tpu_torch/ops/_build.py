"""Build, load and launch the port's CUDA kernels (plain C entry points, ctypes).

Each source under `csrc/` is compiled at first use with nvcc for Hopper
(`sm_90a`) into `build/torch_ext/`, named by a hash of the source and the
flags so an unchanged source is never rebuilt. No `--use_fast_math` and no
`-ftz=true`: the kernels keep IEEE division and denormals, and
`-fmad=false` keeps their rounding equal to the plain PyTorch versions'.
`-Xptxas -v` makes ptxas report each kernel's registers, stack frame,
spills and shared memory; `ptxas_report` returns that report.

Every wrapper launches through `entry` and `launch`: `entry` configures a
C launcher's argument and result types once per (source, function), and
`launch` passes pointers and the stream as plain Python ints, so a launch
builds no ctypes objects and enters no device guard it does not need. It
reads the current device and stream through torch's raw getters, which
return ints: `torch.cuda.current_stream()` builds a Stream object on every
call, which costs more host time than the kernel launch itself
(`python -m gltf_renderer_tpu_torch.tools.bench_launch`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from gltf_renderer_tpu_torch.ops.bvh import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

VP = ctypes.c_void_p  # a pointer or a stream, passed as a Python int
CI = ctypes.c_int

_LOADED = {}
_REPORTS = {}
_ENTRIES = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_define(source: str, name: str):
    """The number that csrc/<source> gives the macro `name` in a line
    `#define name <number>` (an int, or a float for a literal with a point
    or an f suffix), so Python reads a kernel's constant from the one
    place that sets it."""
    with open(os.path.join(CSRC, source)) as f:
        for line in f:
            words = line.split()
            if words[:2] == ["#define", name] and len(words) > 2:
                lit = words[2]
                return float(lit.rstrip("fF")) if "." in lit or lit[-1] in "fF" else int(lit)
    raise KeyError(f"{source} does not #define {name}")


def library_path(source: str) -> str:
    """Path of the shared library built from csrc/<source> (or from the
    absolute path `source`)."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def load(source: str) -> ctypes.CDLL:
    """Compile csrc/<source> (or the absolute path `source`) if its library
    is missing, then load it."""
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
        _REPORTS[source] = [line for line in proc.stderr.splitlines() if "ptxas" in line
                         or "stack frame" in line]
    lib = ctypes.CDLL(lib_path)
    _LOADED[source] = lib
    return lib


def ptxas_report(source: str) -> list:
    """ptxas's resource lines from this process's build of `source`, or an
    empty list if its library was already built when it was loaded."""
    return _REPORTS.get(source, [])


def entry(source: str, name: str, argtypes):
    """The C function `name` of csrc/<source>'s library, with its argument
    types set to `argtypes` and its result typed int (a CUDA error code),
    configured at its first call and cached after."""
    fn = _ENTRIES.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.argtypes = argtypes
        fn.restype = CI
        _ENTRIES[(source, name)] = fn
    return fn


def launch(fn, what: str, device_index: int, *args) -> None:
    """Call the C launcher `fn` with `args` and the current stream of CUDA
    device `device_index`; raise if it returns a CUDA error code. The device
    guard is entered only when that device is not the current one."""
    if device_index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    else:
        with torch.cuda.device(device_index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
