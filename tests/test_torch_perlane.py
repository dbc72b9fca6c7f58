"""Torch port of the per-lane fetch study (ops/perlane.py) vs
tools/bench_perlane.py.

The plain versions `onehot_fetch_ref` and `shuffle_fetch_ref` are held
against the TPU kernels `make_onehot_kernel` and `make_shuffle_kernel`.
Those makers take no `interpret` argument, so the test wraps
`jax.experimental.pallas.pallas_call` in `interpret=True` for the call; the
makers look it up when they run. Tolerance: none. A bf16 -> f32 fetch is
exact, the one-hot product picks one row exactly, and the port adds in the
kernels' order, so acc must be identical.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from gltf_renderer_tpu_torch.ops import perlane
from gltf_renderer_tpu_torch.tools import bench_perlane as port_perlane
from tools import bench_perlane as jax_perlane

torch.set_num_threads(2)

# (n_rows, n_cols, steps): a table of whole 128-row groups, and a ragged one.
SHAPES = [(256, 16, 4), (300, 24, 6)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("n,c,steps", SHAPES)
def test_onehot_plain_equals_the_tpu_kernel(interpret, n, c, steps):
    rs = np.random.RandomState(n)
    ids = torch.from_numpy(rs.randint(0, n, (perlane.ROWS, perlane.LANES)).astype(np.int32))
    # Scaled so int(s) moves ids by more than the step index.
    table = torch.from_numpy((rs.rand(n, c) * 3).astype(np.float32)).to(torch.bfloat16)
    want = jax_perlane.make_onehot_kernel(n, c, steps)(
        jnp.asarray(ids.numpy()), jnp.asarray(table.float().numpy(), jnp.bfloat16))
    got = perlane.onehot_fetch(ids, table, steps)  # CPU tensors: the plain version
    _same_bits(got.numpy(), want)


@pytest.mark.parametrize("n,c,steps", SHAPES)
def test_shuffle_plain_equals_the_tpu_kernel(interpret, n, c, steps):
    rs = np.random.RandomState(n + 1)
    ids = torch.from_numpy(rs.randint(0, n, (1, perlane.LANES)).astype(np.int32))
    table = torch.from_numpy((rs.rand(-(-n // perlane.LANES) * c, perlane.LANES) * 3)
                             .astype(np.float32))
    want = jax_perlane.make_shuffle_kernel(n, c, steps)(jnp.asarray(ids.numpy()),
                                                        jnp.asarray(table.numpy()))
    got = perlane.shuffle_fetch(ids, table, n, c, steps)
    _same_bits(got.numpy(), want)


def test_ids_outside_the_table_fetch_zeros(interpret):
    """An id outside the table fetches nothing in the TPU kernels (an empty
    one-hot row, no group selected); the plain versions agree."""
    n, c, steps = 256, 16, 3
    rs = np.random.RandomState(9)
    ids = rs.randint(0, n, (perlane.ROWS, perlane.LANES)).astype(np.int32)
    ids[0, :4] = [-1, n, n + 200, -300]
    table = torch.from_numpy(rs.rand(n, c).astype(np.float32)).to(torch.bfloat16)
    want = jax_perlane.make_onehot_kernel(n, c, steps)(
        jnp.asarray(ids), jnp.asarray(table.float().numpy(), jnp.bfloat16))
    _same_bits(perlane.onehot_fetch_ref(torch.from_numpy(ids), table, steps).numpy(), want)
    s_ids = ids[:1].copy()
    s_table = torch.from_numpy(rs.rand(2 * c, perlane.LANES).astype(np.float32))
    want = jax_perlane.make_shuffle_kernel(n, c, steps)(jnp.asarray(s_ids),
                                                        jnp.asarray(s_table.numpy()))
    _same_bits(perlane.shuffle_fetch_ref(torch.from_numpy(s_ids), s_table, n, c, steps).numpy(),
               want)


def test_visited_rows_are_the_rows_fetched():
    n, c, steps = 256, 16, 4
    rs = np.random.RandomState(2)
    ids, table = port_perlane.onehot_inputs(rs, n, c, "cpu")
    visited = torch.zeros(n, dtype=torch.bool)
    perlane.onehot_fetch_ref(ids, table, steps, visited=visited)
    assert visited[ids.reshape(-1).long()].all() and 0 < int(visited.sum()) <= n


def test_wrappers_refuse_bad_inputs():
    ids = torch.zeros((perlane.ROWS, perlane.LANES), dtype=torch.int32)
    with pytest.raises(TypeError):
        perlane.onehot_fetch(ids, torch.zeros((64, 16)), 2)  # f32, not bf16
    with pytest.raises(ValueError):
        perlane.onehot_fetch(ids, torch.zeros((64, 4), dtype=torch.bfloat16), 2)  # < 8 columns
    with pytest.raises(ValueError):
        perlane.shuffle_fetch(ids[:1], torch.zeros((16, perlane.LANES)), 300, 8, 2)  # 3 groups


def test_tool_runs_on_cpu(capsys):
    rows = port_perlane.main("cpu")
    assert len(rows) == 2 * len(port_perlane.SHAPES)
    assert all(r["ms"] is None for r in rows)
    assert "no time on the CPU" in capsys.readouterr().out
