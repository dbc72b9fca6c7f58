"""Torch port of the per-lane fetch study (ops/perlane.py) vs
tools/bench_perlane.py.

The plain versions `onehot_fetch_ref` and `shuffle_fetch_ref` are held
against the TPU kernels `make_onehot_kernel` and `make_shuffle_kernel`.
Those makers take no `interpret` argument, so the test wraps
`jax.experimental.pallas.pallas_call` in `interpret=True` for the call; the
makers look it up when they run. Tolerance: none. A bf16 -> f32 fetch is
exact, the one-hot product picks one row exactly, and the port adds in the
kernels' order, so acc must be identical; only where a non-finite table
entry poisons the one-hot product (0 x inf and 0 x NaN are NaN) are the
NaN payloads the hardware's (XLA on x86 gives 0xFFC00000 for 0 x inf,
torch 0x7FC00000), and there NaN must lie in the same places and every
other value be identical.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from gltf_renderer_tpu_torch.ops import perlane
from gltf_renderer_tpu_torch.utils.math import trunc_i32
from gltf_renderer_tpu_torch.tools import bench_perlane as port_perlane
from tools import bench_perlane as jax_perlane

import perlane_tables
from perlane_tables import adversarial_table

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


def _same_bits_or_nan(a, b):
    """NaN in the same places, identical bits everywhere else."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    _same_bits(np.where(np.isnan(a), 0.0, a), np.where(np.isnan(b), 0.0, b))


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


def test_trunc_i32_is_xla_convert():
    """The port's float-to-int (the plain versions', the texture samplers')
    is XLA's astype(int32): toward zero, saturating, NaN to 0 (torch's CPU
    cast maps NaN and >= 2^31 to -2^31)."""
    x = np.array([0.5, -0.5, 1.5, -1.5, 2.0 ** 31 - 128, 2.0 ** 31, 3e9, -3e9, -2.0 ** 31,
                  -2.0 ** 31 - 256, np.inf, -np.inf, np.nan], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(trunc_i32(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("kernel,kind", [("onehot", k) for k in perlane_tables.ONEHOT_KINDS]
                         + [("shuffle", k) for k in perlane_tables.KINDS])
def test_plain_versions_cast_as_xla(interpret, kernel, kind):
    """Both plain versions against the JAX kernels on tables whose fetched
    values are negative, wrap the int32 sum, saturate the cast, are NaN or
    +-inf (perlane_tables); on the one-hot kernel the last two poison
    every lane."""
    n, steps = 200, 4
    rs = np.random.RandomState(sum(map(ord, kernel + kind)))
    if kernel == "onehot":
        c = perlane.SUM_COLS
        ids = rs.randint(0, n, (perlane.ROWS, perlane.LANES)).astype(np.int32)
        table = torch.from_numpy(adversarial_table(rs, n, c, kind)).to(torch.bfloat16)
        want = jax_perlane.make_onehot_kernel(n, c, steps)(
            jnp.asarray(ids), jnp.asarray(table.float().numpy(), jnp.bfloat16))
        got = perlane.onehot_fetch(torch.from_numpy(ids), table, steps)
    else:
        c = 4
        ids = rs.randint(0, n, (1, perlane.LANES)).astype(np.int32)
        table = perlane_tables.shuffle_table(rs, n, c, kind)
        want = jax_perlane.make_shuffle_kernel(n, c, steps)(jnp.asarray(ids), jnp.asarray(table))
        got = perlane.shuffle_fetch(torch.from_numpy(ids), torch.from_numpy(table), n, c, steps)
    if kernel == "onehot" and kind in perlane_tables.POISON_KINDS:
        assert np.isnan(np.asarray(want)).all()
        _same_bits_or_nan(got.numpy(), want)
    else:
        _same_bits(got.numpy(), want)


def _lone_table(rs, n, c, rows, col=3, value=np.inf):
    """(n, c) bf16 of small finite values with `value` at (row, col) for
    each row of `rows`."""
    t = (rs.rand(n, c) * 3).astype(np.float32)
    t[list(rows), col] = value
    return torch.from_numpy(t).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["unvisited_row", "column_8_up", "own_row", "two_rows"])
def test_onehot_poison_follows_the_product(interpret, case):
    """Which lanes a non-finite entry poisons, against the JAX kernel: one
    in a row no lane visits poisons every lane (the product multiplies 0
    by it); in column 8 or beyond, none (s sums columns 0-7); the lanes
    on the one row that holds it fetch their own sum (1 x inf, every
    other term 0), every other lane NaN; two such rows poison every lane."""
    n, c = 200, 16
    rs = np.random.RandomState(sum(map(ord, case)))
    ids = rs.randint(0, 100, (perlane.ROWS, perlane.LANES)).astype(np.int32)
    steps = 4
    if case == "unvisited_row":
        table = _lone_table(rs, n, c, [n - 1])
    elif case == "column_8_up":
        table = _lone_table(rs, n, c, [5, 150], col=8)
        table[7, 12] = float("nan")
    elif case == "own_row":
        steps = 1
        ids[ids == 5] = 6
        ids[0, :64] = 5
        table = _lone_table(rs, n, c, [5], value=-np.inf)
    else:
        table = _lone_table(rs, n, c, [5, 6])
    want = np.asarray(jax_perlane.make_onehot_kernel(n, c, steps)(
        jnp.asarray(ids), jnp.asarray(table.float().numpy(), jnp.bfloat16)))
    visited = torch.zeros(n, dtype=torch.bool)
    got = perlane.onehot_fetch_ref(torch.from_numpy(ids), table, steps, visited=visited)
    _same_bits_or_nan(got.numpy(), want)
    nan = np.isnan(want)
    if case == "unvisited_row":
        assert not bool(visited[n - 1]) and nan.all()
    elif case == "column_8_up":
        assert not nan.any()
    elif case == "own_row":
        assert (want[0, :64] == -np.inf).all() and nan.reshape(-1)[64:].all()
    else:
        assert nan.all()


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
    assert all(r["ms"] is None and r["latency_floor_ms"] is None for r in rows)
    assert all(0.0 <= r["l1_hit_ceiling"] < 1.0 for r in rows)
    assert "no time on the CPU" in capsys.readouterr().out


@pytest.mark.parametrize("level", ["l1", "l2", "smem"])
def test_latency_probe_needs_the_card(level):
    with pytest.raises(ValueError, match="CUDA device"):
        port_perlane.hit_latency_ns("cpu", level)


def test_l1_hit_ceiling_counts_each_blocks_first_touches():
    """A line a block touches misses L1 once: lanes that all walk the same
    rows in one block share every line; in separate blocks each block pays
    its own first touches. The shuffle chains' lines are those of column 0."""
    n, c, steps = 512, 16, 4
    table = torch.zeros((n, c), dtype=torch.bfloat16)   # s = 0: id advances by i
    same = torch.zeros((16, 128), dtype=torch.int32)
    rows_a_line = port_perlane.LINE_BYTES // (c * 2)    # 4 rows of 32 B share a line
    blocks = 2048 // port_perlane.ONEHOT_BLOCK          # 8 blocks of 256 lanes
    # ids 0, 0, 1, 3: lines 0, 0, 0, 0 -> one line for the whole block
    got = port_perlane.l1_hit_ceiling("onehot", same, table, n, c, steps)
    assert got == 1.0 - blocks / (2048 * steps)         # one line each block
    spread = torch.arange(2048, dtype=torch.int32).reshape(16, 128) * rows_a_line % n
    got = port_perlane.l1_hit_ceiling("onehot", spread, table, n, c, steps)
    assert 0.0 <= got < 1.0 - blocks / (2048 * steps)
    s_table = torch.zeros((-(-n // 128) * c, 128), dtype=torch.float32)
    s_ids = torch.zeros((1, 128), dtype=torch.int32)
    got = port_perlane.l1_hit_ceiling("shuffle", s_ids, s_table, n, c, steps)
    assert got == 1.0 - 1 / (128 * steps)               # ids 0..3: one 128-byte line


@pytest.mark.parametrize("kind", ["onehot", "shuffle"])
def test_chain_ids_are_the_plain_versions_fetches(kind):
    """`chain_ids` lists the ids the plain version fetches, step by step,
    and is not counted as a plain-version call."""
    rng = np.random.RandomState(7)
    n, c, steps = 768, 112, 6
    if kind == "onehot":
        ids, table = port_perlane.onehot_inputs(rng, n, c, "cpu")
        visited = torch.zeros(n, dtype=torch.bool)
        perlane.onehot_fetch_ref(ids, table, steps, visited=visited)
    else:
        ids, table = port_perlane.shuffle_inputs(rng, n, c, "cpu")
        visited = torch.zeros(table.shape[0] // c * perlane.LANES, dtype=torch.bool)
        perlane.shuffle_fetch_ref(ids, table, n, c, steps, visited=visited)
    calls = perlane.REFERENCE_CALLS
    got = perlane.chain_ids(kind, ids, table, n, c, steps)
    assert perlane.REFERENCE_CALLS == calls
    assert got.shape == (steps, ids.numel())
    assert torch.equal(got[0], ids.reshape(-1))
    assert set(got.reshape(-1).tolist()) == set(torch.nonzero(visited)[:, 0].tolist())


F2I_BIAS = 0x4B000000  # the bits of 2^23 (csrc/perlane.cu)
M32 = 0xFFFFFFFF


def _bound(n):
    """csrc/perlane.cu's shuffle_fetch_launch: the fast step's bound (2n;
    0, every step rare, from n = 2^29, where 4x would wrap)."""
    return 2 * n if n < 2 ** 29 else 0


def _fast_off(o, bits, i, n, bound):
    """csrc/perlane.cu's fast_next_off, in torch on uint32 values held in
    int64 tensors, from the byte offset o = 4 id, the FADD's bits and the
    step i: (the next byte offset, the unsigned min of 4x, 4x - 4n and
    4(n - 1); whether the step is rare, x >= bound unsigned)."""
    c = (o + 4 * (i - F2I_BIAS)) & M32
    x4 = (bits * 4 + c) & M32
    xn4 = (bits * 4 + ((c - 4 * n) & M32)) & M32
    x = ((o >> 2) + bits + i - F2I_BIAS) & M32
    got = torch.minimum(torch.minimum(x4, xn4), torch.tensor(4 * (n - 1)))
    return got, x >= bound


def _fast_trunc(f0):
    """fast_next_id's int(f0) for float32 f0 (a numpy array): the bits of
    f0 + 2^23 rounded toward zero, less F2I_BIAS; and whether f0 is rare
    (its bits, unsigned, at or above F2I_BIAS: negative, >= 2^23, NaN)."""
    with np.errstate(invalid="ignore", over="ignore"):
        y = f0.astype(np.float64) + 2.0 ** 23
        y32 = y.astype(np.float32)
        away = np.abs(y32.astype(np.float64)) > np.abs(y)
        y32 = np.where(away, np.nextafter(y32, np.float32(0)), y32)
    bits = y32.view(np.uint32).astype(np.int64)
    return torch.from_numpy(bits - F2I_BIAS), torch.from_numpy(f0.view(np.uint32) >= F2I_BIAS)


@pytest.mark.parametrize("n", [1, 2, 129, 6400, 2 ** 29 - 1, 2 ** 29, 2 ** 30 - 1, 2 ** 30,
                               2 ** 31 - 1])
def test_kernel_id_step_is_the_floor_modulo(n):
    """The kernel's fast id step on byte offsets gives 4 torch.remainder(x,
    n) for every wrapped int32 sum x = id + int(f0) + i it does not flag as
    rare (all boundaries, 4096 random sums and 1024 in [0, 2n)), flags
    none in [0, bound), and always lands on an id in [0, n)."""
    bound = _bound(n)
    edges = [0, 1, n - 1, n, n + 1, 2 * n - 1, 2 * n, 2 * n + 1, -1, -n, -n - 1, -2 * n,
             2 ** 31 - 1, 2 ** 31 - n, -2 ** 31, -2 ** 31 + n, 2 ** 30, -2 ** 30, 2 ** 29]
    rs = np.random.RandomState(n % 1000)
    x = np.concatenate([np.array(edges, np.int64), rs.randint(-2 ** 31, 2 ** 31, 4096),
                        rs.randint(0, 2 * n, 1024)])
    x = torch.from_numpy(((x + 2 ** 31) % 2 ** 32) - 2 ** 31)  # as int32 values
    ids = torch.from_numpy(rs.randint(0, n, x.numel()).astype(np.int64))
    i = torch.from_numpy(rs.randint(1, 64, x.numel()).astype(np.int64))
    bits = (x - ids - i + F2I_BIAS) & M32  # int(f0) = x - id - i, wrapped
    got, rare = _fast_off(4 * ids, bits, i, n, bound)
    want = 4 * torch.remainder(x.to(torch.int32), n).long()
    assert torch.equal(got[~rare], want[~rare])
    assert bool(((got % 4 == 0) & (got >= 0) & (got < 4 * n)).all())
    assert not bool(rare[(x >= 0) & (x < bound)].any())
    assert bool(rare.all()) == (bound == 0)


def test_kernel_fast_trunc_is_exact_or_rare():
    """fast_next_id's int(f0) by an FADD equals the saturating cast on every
    f0 it does not flag as rare, and flags none in [0, 2^23)."""
    edges = [0.0, -0.0, 1e-45, 0.5, 1.5, 2.0 ** 23 - 1, 2.0 ** 23 - 0.5, 2.0 ** 23, -0.5, -1.0,
             3e9, -3e9, 2.0 ** 31 - 128, 1e30, np.inf, -np.inf, np.nan]
    rs = np.random.RandomState(3)
    f0 = np.concatenate([np.array(edges), rs.rand(2048) * 3, rs.rand(1024) * 2.0 ** 23,
                         (rs.rand(1024) - 0.5) * 1e10]).astype(np.float32)
    got, rare = _fast_trunc(f0)
    want = trunc_i32(torch.from_numpy(f0)).long()
    assert torch.equal(got[~rare], want[~rare])
    small = torch.from_numpy((f0 >= 0) & (f0 < 2.0 ** 23) & ~np.signbit(f0))
    assert not bool(rare[small].any()) and bool(rare[~small].all())


def _onehot_kernel_emulation(ids, table, steps, ranks=8):
    """csrc/perlane.cu's onehot kernel in torch, for one cluster of `ranks`
    blocks: rank q sums rows [q per, (q + 1) per) (per a multiple of 4),
    each row's 8 columns left to right, and finds its lowest and highest
    row holding a non-finite entry; the sums are reassembled (each rank's
    copy is the same), the cluster's lowest and highest bad row are the
    min and max over the ranks (the kernel's warps report them, which
    reduces the same), and where one exists every row's sum but the lone
    bad row's (lowest == highest) is NaN. Then each lane's chain by the
    fast offset step (`_fast_trunc`, `_fast_off`) from step 0, an id
    outside the table making the lane rare; the rare lanes walked again
    exactly (step 0 apart: an id outside the table fetches 0, or NaN where
    the table is poisoned)."""
    n = table.shape[0]
    per = (-(-n // ranks) + 3) // 4 * 4
    sums = torch.zeros(-(-n // 4) * 4)
    lo, hi = 2 ** 31 - 1, -1
    for q in range(ranks):
        r0, r1 = q * per, min(n, (q + 1) * per)
        if r0 >= r1:
            continue
        rows = table[r0:r1, :perlane.SUM_COLS].float()
        acc = torch.zeros(r1 - r0)
        for k in range(perlane.SUM_COLS):
            acc = acc + rows[:, k]
        sums[r0:r1] = acc
        bad = torch.nonzero(~torch.isfinite(rows).all(dim=1))[:, 0] + r0
        if bad.numel():
            lo, hi = min(lo, int(bad.min())), max(hi, int(bad.max()))
    poisoned = hi >= 0
    if poisoned:
        sums = torch.where(torch.arange(sums.numel()) == (lo if lo == hi else -1), sums,
                           float("nan"))
    if steps <= 0:
        return torch.zeros(ids.shape)
    id0 = ids.reshape(-1)
    valid = (id0 >= 0) & (id0 < n)
    s0 = torch.where(valid, sums[id0.clamp(0, n - 1).long()], float("nan") if poisoned else 0.0)

    def walk(exact):
        if exact:
            first, o, acc = 1, 4 * torch.remainder(id0 + trunc_i32(s0), n).long(), 0.0 + s0
        else:
            first, o, acc = 0, torch.where(valid, 4 * id0.long(), 0), torch.zeros(id0.shape)
        rare = ~valid
        for i in range(first, steps):
            f = sums[o // 4]
            acc = acc + f
            if exact:
                o = 4 * torch.remainder((o // 4).int() + trunc_i32(f) + i, n).long()
            else:
                trunc, f_rare = _fast_trunc(f.numpy())
                o, x_rare = _fast_off(o, trunc + F2I_BIAS, i, n, _bound(n))
                rare |= f_rare | x_rare
        return acc, rare

    fast, rare = walk(False)
    return torch.where(rare, walk(True)[0], fast).reshape(ids.shape)


@pytest.mark.parametrize("kind", perlane_tables.KINDS + ("lone",))
@pytest.mark.parametrize("n", [1, 7, 9, 200])
def test_onehot_kernel_staging_is_the_plain_version(kind, n):
    """The onehot kernel's design, emulated in torch (rows split over 8
    ranks, the sums reassembled, the poison's bad rows min / max over the
    ranks, the fast step with its exact rerun), equals `onehot_fetch_ref`
    bit for bit on every adversarial table, on one whose lone non-finite
    entry lies on a row the lanes visit, at ids outside the table and at
    the int32 edges, over 0, 1 and 33 steps."""
    rs = np.random.RandomState(n + sum(map(ord, kind)))
    c = 9
    ids = rs.randint(0, n, (perlane.ROWS, perlane.LANES)).astype(np.int32)
    ids[0, :6] = [-1, n, 5 * n, -2 ** 31, 2 ** 31 - 1, -n - 3]
    if kind == "lone":
        row = n // 2
        table = _lone_table(rs, n, c, [row], col=2)
        ids[1, :32] = row
    else:
        table = torch.from_numpy(adversarial_table(rs, n, c, kind)).to(torch.bfloat16)
    ids = torch.from_numpy(ids)
    for steps in (0, 1, 33):
        _same_bits(_onehot_kernel_emulation(ids, table, steps).numpy(),
                   perlane.onehot_fetch_ref(ids, table, steps).numpy())


@pytest.mark.parametrize("level", ["l1", "l2", "smem"])
def test_chase_chain_is_one_cycle(level):
    """Each pointer chase follows one cycle through every entry of its
    chain (every 32nd int, one a 128-byte line; every int in shared memory,
    which holds the whole chain), and the chase kernel's lane starts,
    multiples of 32 ints, are entries."""
    size, gap = port_perlane.CHASE[level]
    chain = port_perlane.chase_chain(level)
    assert chain.shape == (size,) and chain.dtype == np.int32
    assert not chain[np.arange(size) % gap != 0].any()
    at, seen = 0, 0
    for _ in range(size // gap):
        at = int(chain[at])
        seen += 1
        assert at % gap == 0 and (at != 0 or seen == size // gap)
    assert at == 0
    if level == "smem":
        assert size * 4 <= 48 * 1024  # the launch's shared memory, no opt-in needed


@pytest.mark.parametrize("h,staged", [(0.951, True), (0.0, True), (1.0, False)])
def test_latency_floor_takes_the_cheaper_design(h, staged):
    """A chain's floor is the cheaper of reading in place (h of the loads
    L1 hits, the rest L2) and staging (one L2 round trip, then every load
    from shared memory)."""
    lat = {"l1": 20.0, "l2": 150.0, "smem": 17.0}
    in_place = 32 * (h * 20.0 + (1 - h) * 150.0)
    staged_ns = 150.0 + 32 * 17.0
    got = port_perlane.latency_floor_ns(h, lat, 32)
    assert got == pytest.approx(staged_ns if staged else in_place)


def test_fit_line_recovers_slope_and_intercept():
    xs = port_perlane.SWEEP_STEPS
    slope, icpt = port_perlane.fit_line(xs, [2.3 + 0.033 * x for x in xs])
    assert slope == pytest.approx(0.033) and icpt == pytest.approx(2.3)


def test_study_lines_write_a_missing_profiler_reading():
    """torch.profiler may record no launch of a kernel: its reading is then
    [None, 0], which the study's lines and chip_smoke's phase 9 log line
    (both `format_numbers`) write as "not recorded" instead of failing."""
    missing = port_perlane._kernel_us({}, "onehot_fetch")
    assert missing == [None, 0]
    found = port_perlane._kernel_us({"onehot_fetch_kernel<true>": (3.5, 2)}, "onehot_fetch")
    assert found == [3.5, 2]
    row = {"new_profiler_us": missing, "new_graph_us": [3.21234, 3.2]}
    assert (port_perlane.format_numbers(row)
            == "new_profiler_us [not recorded, 0], new_graph_us [3.212, 3.2]")
    dev = {"graph_us": 3.20001, "profiler_us": None, "profiler_launches": 0}
    assert (port_perlane.format_numbers(dev, 4)
            == "graph_us 3.2, profiler_us not recorded, profiler_launches 0")
