"""Per-lane row fetch: chains of dependent table reads.

Port of tools/bench_perlane.py's two study kernels, which size the per-lane
row fetch one traversal step needs. Each lane walks `steps` dependent
fetches: the value it fetches decides the row it fetches next.

- `onehot_fetch(ids, table, steps)` (TPU `make_onehot_kernel`): ids
  (16, 128) int32, table (n, c) bf16 with c >= 8. Per lane and step i,
  s = the sum of the lane's row's first 8 columns, acc += s,
  id = (id + int(s) + i) mod n. Returns acc, (16, 128) f32.
- `shuffle_fetch(ids, table, n_rows, n_cols, steps)` (TPU
  `make_shuffle_kernel`): ids (1, 128) int32, table (ceil(n/128) * c, 128)
  f32, G groups of (c, 128). Per lane and step i,
  fetched[k] = table[(id // 128) * c + k, id % 128], acc[k] += fetched[k],
  id = (id + int(fetched[0]) + i) mod n. Returns acc, (c, 128) f32.

int() truncates toward zero, mod is the floor modulo, and an id outside the
table fetches zeros, as in the JAX kernels. A CPU tensor goes to the plain
version (`*_ref`); a CUDA tensor goes to the CUDA kernel (csrc/perlane.cu),
or the call raises. The plain versions add in the JAX kernels' order, so
kernel, plain version and JAX kernel agree bit for bit.
`KERNEL_LAUNCHES` counts each kernel's launches by name and
`REFERENCE_CALLS` the plain-version calls.
"""

from __future__ import annotations

import torch

from gltf_renderer_tpu_torch.ops import _build

ROWS, LANES = 16, 128  # the one-hot kernel's 2048-lane packet
SUM_COLS = 8           # columns the one-hot step sums

KERNEL_LAUNCHES = {"onehot_fetch": 0, "shuffle_fetch": 0}
REFERENCE_CALLS = 0

_SOURCE = "perlane.cu"
_ARGTYPES = [_build.VP, _build.VP] + [_build.CI] * 4 + [_build.VP] * 2  # both launchers


def _groups(n_rows: int) -> int:
    return -(-n_rows // LANES)


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, ids on {device}")


def _check_onehot(ids, table):
    if table.dim() != 2 or table.shape[1] < SUM_COLS or table.shape[0] < 1:
        raise ValueError(f"table must be (n, c) with n >= 1 and c >= {SUM_COLS}, "
                         f"got {tuple(table.shape)}")
    _check("ids", ids, torch.int32, (ROWS, LANES), ids.device)
    _check("table", table, torch.bfloat16, table.shape, ids.device)


def _check_shuffle(ids, table, n_rows, n_cols):
    if n_rows < 1 or n_cols < 1:
        raise ValueError(f"n_rows and n_cols must be positive, got {n_rows}, {n_cols}")
    _check("ids", ids, torch.int32, (1, LANES), ids.device)
    _check("table", table, torch.float32, (_groups(n_rows) * n_cols, LANES), ids.device)


def _launch(fn_name, ids, table, out, *ints):
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"{fn_name} runs on cpu or cuda tensors, got {dev}")
    ids, table = ids.contiguous(), table.contiguous()
    _build.launch(_build.entry(_SOURCE, f"{fn_name}_launch", _ARGTYPES), fn_name, dev.index,
                  ids.data_ptr(), table.data_ptr(), *ints, out.data_ptr())
    KERNEL_LAUNCHES[fn_name] += 1
    return out


def onehot_fetch(ids, table, steps: int):
    """`steps` dependent 8-column row fetches per lane; returns acc."""
    _check_onehot(ids, table)
    if ids.device.type == "cpu":
        return onehot_fetch_ref(ids, table, steps)
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    return _launch("onehot_fetch", ids, table, out, table.shape[0], table.shape[1],
                   int(steps), ids.numel())


def shuffle_fetch(ids, table, n_rows: int, n_cols: int, steps: int):
    """`steps` dependent c-value column fetches per lane; returns acc."""
    _check_shuffle(ids, table, n_rows, n_cols)
    if ids.device.type == "cpu":
        return shuffle_fetch_ref(ids, table, n_rows, n_cols, steps)
    out = torch.empty((n_cols, LANES), dtype=torch.float32, device=ids.device)
    return _launch("shuffle_fetch", ids, table, out, n_rows, n_cols, _groups(n_rows),
                   int(steps))


def _onehot_chain(ids, table, steps: int):
    """The one-hot chain, step by step: yields (valid, ids, s) for each
    step, the flat lanes' row ids before the fetch and the sums fetched."""
    n = table.shape[0]
    cols = table[:, :SUM_COLS].float()
    idv = ids.reshape(-1)
    for i in range(steps):
        valid = (idv >= 0) & (idv < n)
        rows = torch.where(valid[:, None], cols[idv.clamp(0, n - 1).long()], 0.0)
        s = torch.zeros(idv.shape, dtype=torch.float32, device=ids.device)
        for k in range(SUM_COLS):
            s = s + rows[:, k]
        yield valid, idv, s
        idv = torch.remainder(idv + s.to(torch.int32) + i, n)


def _shuffle_chain(ids, table, n_rows: int, n_cols: int, steps: int):
    """The shuffle chain, step by step: yields (valid, ids, fetched) for
    each step, the 128 lane ids before the fetch and the (c, 128) values
    fetched."""
    groups = _groups(n_rows)
    k = torch.arange(n_cols, device=ids.device)[:, None]
    idv = ids[0]
    for i in range(steps):
        grp = torch.div(idv, LANES, rounding_mode="floor")
        valid = (grp >= 0) & (grp < groups)
        rows = grp.clamp(0, groups - 1).long()[None, :] * n_cols + k
        cols = torch.remainder(idv, LANES).long()[None, :]
        fetched = torch.where(valid[None, :], table[rows, cols], 0.0)
        yield valid, idv, fetched
        idv = torch.remainder(idv + fetched[0].to(torch.int32) + i, n_rows)


def chain_ids(kind: str, ids, table, n_rows: int, n_cols: int, steps: int):
    """The ids each lane fetches at each step of `kind`'s chain ("onehot" or
    "shuffle"), (steps, lanes) int32, from the plain version's steps. A
    measurement of the inputs, not a plain-version call: not counted."""
    if kind == "onehot":
        _check_onehot(ids, table)
        chain = _onehot_chain(ids, table, steps)
    else:
        _check_shuffle(ids, table, n_rows, n_cols)
        chain = _shuffle_chain(ids, table, n_rows, n_cols, steps)
    return torch.stack([idv for _, idv, _ in chain])


def onehot_fetch_ref(ids, table, steps: int, visited=None):
    """Plain PyTorch version of `onehot_fetch`. visited: an optional (n,)
    bool tensor in which the rows the lanes fetch are set, the rows the
    kernel reads on these inputs."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    _check_onehot(ids, table)
    acc = torch.zeros(ids.numel(), dtype=torch.float32, device=ids.device)
    for valid, idv, s in _onehot_chain(ids, table, steps):
        if visited is not None:
            visited[idv[valid].long()] = True
        acc = acc + s
    return acc.reshape(ids.shape)


def shuffle_fetch_ref(ids, table, n_rows: int, n_cols: int, steps: int, visited=None):
    """Plain PyTorch version of `shuffle_fetch`. visited: an optional
    (G * 128,) bool tensor in which the ids the lanes fetch are set (each
    one a column of c values the kernel reads on these inputs)."""
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    _check_shuffle(ids, table, n_rows, n_cols)
    acc = torch.zeros((n_cols, LANES), dtype=torch.float32, device=ids.device)
    for valid, idv, fetched in _shuffle_chain(ids, table, n_rows, n_cols, steps):
        if visited is not None:
            visited[idv[valid].long()] = True
        acc = acc + fetched
    return acc
