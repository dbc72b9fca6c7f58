"""Multi-process rendering on torch.distributed: joining the group, the
rank's device, and the scene tables on it.

Port of gltf_renderer_tpu/parallel/distributed.py. One process renders on
one device. Nothing but the frame's collectives crosses between ranks
(parallel/sharding.py): each rank loads the same glTF file itself, the
scene build is deterministic, and the RNG is keyed by absolute pixel
coordinates, so every rank holds the same tables and computes the same
pixels of its cells. There is no asset broadcast.

    from gltf_renderer_tpu_torch.parallel import distributed, sharding
    distributed.initialize()               # torchrun's environment; no-op alone
    mesh = sharding.make_mesh(n_sample=1)  # one cell a rank
    img = sharding.render_sharded(ptscene, meta, ..., mesh)

The backend is always chosen, never swapped: "nccl" for CUDA tensors with
one card a rank, "gloo" on the CPU. Ranks that share one card pass
backend="gloo" (NCCL refuses two ranks on one device).

A raise on one rank must not leave the others waiting in a collective.
Every collective of a sharded frame is an `exchange` (an all_gather of
pickled objects) or comes right after one (sharding's frame gathers), so
a rank whose frame raised calls `fail`: it joins the next exchange the
other ranks reach with its error, and there every rank raises RankFailed
naming that rank. No timeout is involved.

`together` applies that protocol to any block every rank runs in step (a
scene load, a Renderer frame, a CLI frame): a raise in the block is passed
to the others, and the block ends with a status exchange, so a raise after
its last collective still meets them. The raising rank raises its own
error, the others RankFailed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gltf_renderer_tpu_torch.device import resolve

BACKENDS = ("nccl", "gloo")


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device="cuda") -> Tuple[int, int]:
    """Join the process group and set the rank's device; returns (rank,
    world_size).

    world_size and rank default to torchrun's WORLD_SIZE and RANK (1 and
    0 when unset), init_method to "env://" (MASTER_ADDR / MASTER_PORT); a
    "file://" or "tcp://" method can be given instead. With a world of 1
    and no init_method it joins nothing (a single process). A process
    already in a group keeps it.

    device "cuda" is the rank's card, cuda:LOCAL_RANK (LOCAL_RANK defaults
    to the rank); "cuda:k" pins a card (two ranks may share one under
    gloo); "cpu" renders on the CPU. backend defaults to "nccl" on a card
    and "gloo" on the CPU."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    dev = resolve(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size == 1 and init_method is None:
        return 0, 1
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return rank, world_size


def uses_host_staging() -> bool:
    """True when the group's collectives run on host memory (gloo): a
    CUDA tensor is then copied to the host explicitly before a collective
    and back after it, so that no path depends on whether the installed
    gloo has a CUDA form of the collective."""
    return dist.get_backend() == "gloo"


class RankFailed(RuntimeError):
    """A rank reported an error at an exchange; every rank raises this
    there, so all of them leave the frame protocol together."""


@dataclasses.dataclass(frozen=True)
class _Failure:
    rank: int
    error: str


def exchange(obj: Any) -> list:
    """Every rank's `obj` in rank order, on every rank (pickled; one
    all_gather_object): the status point of the sharded frame protocol.
    When a rank passed a failure (`fail`), every rank raises RankFailed,
    naming each failed rank and its error, instead of returning."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    failed = [g for g in got if isinstance(g, _Failure)]
    if failed:
        raise RankFailed("; ".join(f"rank {f.rank}: {f.error}" for f in failed))
    return got


def fail(error: BaseException):
    """Pass this rank's error to every rank at the next exchange they all
    reach; raises RankFailed there, as every other rank does."""
    exchange(_Failure(dist.get_rank(), f"{type(error).__name__}: {error}"))


@contextlib.contextmanager
def together(active: bool = True):
    """Run the block on every rank in step. A raise in it is passed to the
    other ranks (`fail`) and raised again here; the block ends with a
    status exchange, where every other rank raises RankFailed naming this
    one. Inactive (a single process), the block runs as it is."""
    if not active:
        yield
        return
    try:
        yield
    except RankFailed:
        raise
    except Exception as e:
        with contextlib.suppress(RankFailed):
            fail(e)
        raise
    exchange(None)


def replicate(tree: Any, mesh) -> Any:
    """A table tree (NamedTuples, lists and tuples of numpy arrays or
    tensors) with every array on the mesh's device, as tensors. Every rank
    calls it on the same values (each loads the same scene file). The
    fields a PTScene keeps on the host for the refit (`bvh`, `packed`)
    stay there."""
    from gltf_renderer_tpu_torch.render.pathtracer import PTScene

    dev = mesh.device

    def put(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, np.ndarray):
            return torch.tensor(x, device=dev)  # a copy: host tables may be read-only
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            host = ("bvh", "packed") if isinstance(x, PTScene) else ()
            return x._replace(**{k: v if k in host else put(v)
                                 for k, v in x._asdict().items()})
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return x

    return put(tree)
