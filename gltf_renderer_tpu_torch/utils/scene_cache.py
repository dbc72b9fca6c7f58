"""Disk cache for the host tables `make_pt_scene` builds.

Port of gltf_renderer_tpu/utils/scene_cache.py. The tables (BVH, packed
leaf and node tables, wide maps, texture mip pyramid, compact material
rows) are a pure function of the (world, materials, textures, lights)
inputs and of the builder code, and cost seconds to minutes at bench scale.
Key = content hash of every input leaf + a digest of the builder sources,
so an edit to any of them misses; value = the pickled host tables.

The cache root is an argument of the callers (`make_pt_scene(cache_dir=)`,
`env.environment.build_environment(cache_dir=)`); None means no cache. The
scene tables live in `<root>/ptscene`, the environment's in `<root>/env`.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import sys
import tempfile

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Sources whose code determines the built tables. Over-inclusion only costs
# a rebuild after an unrelated edit.
_SOURCE_FILES = (
    os.path.join(_PKG, "render", "pathtracer.py"),
    os.path.join(_PKG, "ops", "bvh.py"),
    os.path.join(_PKG, "ops", "texture.py"),
    os.path.join(_PKG, "ops", "material.py"),
    os.path.join(_PKG, "scene", "types.py"),
    os.path.join(os.path.dirname(_PKG), "native", "bvh_builder.cpp"),
)
_VERSION = b"ptscene-cache-v1"


def cache_dir(root):
    """The scene cache's directory under the cache root `root` (None: no cache)."""
    return None if root is None else os.path.join(root, "ptscene")


def _code_digest() -> bytes:
    h = hashlib.sha256(_VERSION)
    for path in _SOURCE_FILES:
        with open(path, "rb") as f:
            h.update(hashlib.sha256(f.read()).digest())
    return h.digest()


def _update(h, x) -> None:
    """Hash x's structure and leaves: tuples (NamedTuples by class name),
    lists and dicts recursively, tensors and arrays by dtype, shape and
    bytes, other leaves by repr."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        h.update(repr((x.shape, str(x.dtype))).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, (tuple, list)):
        h.update(f"{type(x).__name__}[{len(x)}](".encode())
        for item in x:
            _update(h, item)
        h.update(b")")
    elif isinstance(x, dict):
        h.update(f"dict[{len(x)}](".encode())
        for k in sorted(x):
            h.update(repr(k).encode())
            _update(h, x[k])
        h.update(b")")
    else:
        h.update(repr(x).encode())


def compute_key(inputs) -> str:
    """Content hash of a nest of tuples, lists, dicts, tensors, arrays and
    scalars, plus the builder source digest."""
    h = hashlib.sha256(_code_digest())
    _update(h, inputs)
    return h.hexdigest()


def load(key: str, directory):
    """The value stored under `key` in `directory`, or None (no entry, no
    cache, or a torn or stale entry, which is removed)."""
    if directory is None:
        return None
    path = os.path.join(directory, key + ".pkl")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except FileNotFoundError:
        return None
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError, ImportError) as e:
        print(f"[scene_cache] discarding stale entry {path}: {e}", file=sys.stderr)
        try:
            os.remove(path)
        except OSError:
            pass
        return None


def store(key: str, value, directory) -> None:
    """Pickle `value` under `key` in `directory` atomically (no-op for None).
    A failed write is reported, not raised: the build it caches succeeded."""
    if directory is None:
        return
    try:
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(value, f, protocol=4)
        os.replace(tmp, os.path.join(directory, key + ".pkl"))
    except OSError as e:
        print(f"[scene_cache] store failed: {e}", file=sys.stderr)
