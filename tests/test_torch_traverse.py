"""Torch port traversal (ops/traverse.py) vs the JAX package.

The plain PyTorch version `traverse_wide_ref` is held against the TPU
kernel `traverse_packets_wide` run in interpret mode, on the random-soup
fixtures of tests/test_pallas_trace.py (same wide tables fed to both), and
against the XLA packed traversal `bvh.intersect_closest_p` /
`intersect_any_p` for every cull/blend mode. On the soup no two triangles
tie, so closest-hit words must be identical; t must agree to 1e-6 relative,
and u, v (in [0, 1]) to 1e-6 relative plus 1e-5 absolute: the reference's
CPU build contracts the barycentric dot products into fused multiply-adds,
which moves their last bits, and the dot products cancel (measured up to
2.7e-6); the port rounds each product. Any-hit rays report the
first accepted triangle in traversal order, which differs between
traversal orders, so they are compared by occlusion only. A brute-force
numpy test of every triangle, which no visit order can change, holds the
plain version's nearest-child-first traversal on the soup and a closed
mesh for every cull/blend mode.

Interpret-mode calls each compile for ~20 s on the CPU, so the two of them
cover several ray families at once (random, coherent, degenerate and
restarted-past-a-hit rays) and all three lane kinds (lane mode mixes closest
and any-hit rays), with cull +1/-1 and blend EXCLUDE/ONLY.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.ops import bvh as jbvh
from gltf_renderer_tpu.ops.pallas_trace import traverse_packets_wide
from gltf_renderer_tpu_torch.ops import bvh as pbvh
from gltf_renderer_tpu_torch.ops import traverse as tr
from tests.test_pallas_trace import _random_rays, _random_scene

torch.set_num_threads(2)


def _wide_tables(packed):
    """Wide tables of a JAX PackedBVH (as tests/test_pallas_trace.py builds
    them), as numpy."""
    nodes_np = np.asarray(packed.nodes)
    is_leaf = nodes_np[:, 6] >= 0.0
    skip = nodes_np[:, 7].astype(np.int32)
    n = nodes_np.shape[0]
    right = np.full(n, -1, np.int32)
    internal = ~is_leaf
    right[internal] = skip[np.clip(np.nonzero(internal)[0] + 1, 0, n - 1)]
    tree = jbvh.FlatBVH(aabb_min=nodes_np[:, 0:3], aabb_max=nodes_np[:, 3:6],
                        first=np.maximum(nodes_np[:, 6], 0).astype(np.int32),
                        count=is_leaf.astype(np.int32), skip=skip, right=right,
                        tri_order=None, levels=None)
    maps, root = jbvh.build_wide_maps(tree)
    wide = np.asarray(jbvh.assemble_wide(packed.nodes, maps))
    recs = np.asarray(packed.records)[maps.leaf_ids]
    words = np.asarray(packed.words)[maps.leaf_ids]
    return dict(nodes=wide, meta=np.asarray(maps.meta), records=recs, words=words,
                root=root, stack_bound=pbvh.wide_stack_bound(maps.meta, root))


def _ray_families(tables, seed):
    """Random + coherent + degenerate + restarted-past-a-hit rays (numpy)."""
    o1, d1, tmn1, tmx1 = [np.asarray(x) for x in _random_rays(192, seed)]
    o2, d2, tmn2, tmx2 = [np.asarray(x) for x in _random_rays(128, seed + 1, coherent=True)]
    o3 = np.asarray([[0, -3, 0], [0, -3, 0], [-3, 0, 0], [0, 0, 3], [0, 0, 0]], np.float32)
    d3 = np.asarray([[0, 1, 0], [0, 0, 1], [1, 0, 0], [0, 0, -1], [0, -1e-30, 1]], np.float32)
    tmn3 = np.zeros(5, np.float32)
    tmx3 = np.full(5, 20.0, np.float32)
    # Restart the coherent rays just past their first hit (alpha-retry pattern).
    t0, w0, _, _ = _ref(tables, o2, d2, tmn2, tmx2)
    t0, w0 = t0.numpy(), w0.numpy()
    tmn4 = np.where(w0 >= 0, t0 * 1.0001 + 1e-5, tmx2 + 1.0).astype(np.float32)
    o = np.concatenate([o1, o2, o3, o2])
    d = np.concatenate([d1, d2, d3, d2])
    tmn = np.concatenate([tmn1, tmn2, tmn3, tmn4])
    tmx = np.concatenate([tmx1, tmx2, tmx3, tmx2])
    return o, d, tmn, tmx


def _ref(tables, o, d, tmn, tmx, any_hit=False, cull=0, blend=0, mode=None):
    T = lambda x: torch.from_numpy(np.array(x))
    return tr.traverse_wide_ref(
        T(tables["nodes"]), T(tables["meta"]), T(tables["records"]), T(tables["words"]),
        T(o), T(d), T(tmn), T(tmx), tables["root"], any_hit, cull, blend,
        None if mode is None else T(mode), stack_bound=tables["stack_bound"])


def _assert_closest_equal(t, w, u, v, t_ref, w_ref, u_ref, v_ref, lanes):
    np.testing.assert_array_equal(w[lanes], w_ref[lanes])
    hit = lanes & (w_ref >= 0)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-6, atol=0)
    np.testing.assert_allclose(u[hit], u_ref[hit], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(v[hit], v_ref[hit], rtol=1e-6, atol=1e-5)
    miss = lanes & (w_ref < 0)
    np.testing.assert_array_equal(t[miss], t_ref[miss])


@pytest.fixture(scope="module")
def soup():
    return _wide_tables(_random_scene(200, seed=7))


@pytest.mark.parametrize("cull,blend", [(1, jbvh.BLEND_EXCLUDE), (-1, jbvh.BLEND_ONLY)])
def test_ref_matches_pallas_interpret_lane_mode(soup, cull, blend):
    o, d, tmn, tmx = _ray_families(soup, seed=11)
    mode = (np.random.default_rng(5).random(o.shape[0]) < 0.5).astype(np.int32)
    want = traverse_packets_wide(
        jnp.asarray(soup["nodes"]), jnp.asarray(soup["meta"]), jnp.asarray(soup["records"]),
        jnp.asarray(soup["words"]), jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmn),
        jnp.asarray(tmx), root_meta=soup["root"], any_hit="lane", cull_sign=cull,
        blend_mode=blend, mode=jnp.asarray(mode), interpret=True)
    t_ref, w_ref, u_ref, v_ref = [np.asarray(x) for x in want]
    t, w, u, v = [x.numpy() for x in _ref(soup, o, d, tmn, tmx, "lane", cull, blend, mode)]
    closest = mode == 0
    _assert_closest_equal(t, w, u, v, t_ref, w_ref, u_ref, v_ref, closest)
    np.testing.assert_array_equal((w >= 0)[~closest], (w_ref >= 0)[~closest])
    assert np.isfinite(t[closest]).all()
    assert (w_ref >= 0).any() and (~closest & (w_ref >= 0)).any()


@pytest.mark.parametrize("cull", [-1, 0, 1])
@pytest.mark.parametrize("blend", [jbvh.BLEND_ANY, jbvh.BLEND_EXCLUDE, jbvh.BLEND_ONLY])
def test_ref_matches_xla_closest(soup, cull, blend):
    packed = _random_scene(200, seed=7)
    o, d, tmn, tmx = _ray_families(soup, seed=13)
    want = jbvh.intersect_closest_p(packed, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmn),
                                    jnp.asarray(tmx), blend_mode=blend, cull_sign=cull)
    t, w, u, v = [x.numpy() for x in _ref(soup, o, d, tmn, tmx, False, cull, blend)]
    tri = np.where(w >= 0, w & jbvh.ID_MASK, -1)
    lanes = np.ones(o.shape[0], bool)
    _assert_closest_equal(t, tri, u, v, np.asarray(want.t), np.asarray(want.tri),
                          np.asarray(want.u), np.asarray(want.v), lanes)


@pytest.mark.parametrize("cull", [-1, 0, 1])
def test_ref_any_hit_matches_xla_occlusion(soup, cull):
    packed = _random_scene(200, seed=7)
    o, d, tmn, tmx = _ray_families(soup, seed=17)
    want = jbvh.intersect_any_p(packed, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmn),
                                jnp.asarray(tmx), cull_sign=cull)
    t, w, u, v = [x.numpy() for x in _ref(soup, o, d, tmn, tmx, True, cull, 0)]
    np.testing.assert_array_equal(w >= 0, np.asarray(want))
    # A miss keeps t_max; a hit retires the ray with t = NEG_BIG.
    np.testing.assert_array_equal(t[w < 0], tmx[w < 0])
    assert (t[w >= 0] == np.float32(tr.NEG_BIG)).all()


def _mesh_tables():
    """Wide tables of a closed UV sphere (shared edges), as numpy, and the
    packed BVH they come from."""
    from tests.scenes import uv_sphere

    p, _, _, idx = uv_sphere(16, 32)
    tri = idx.reshape(-1, 3)
    p0, p1, p2 = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
    tree = pbvh.build(p0, p1, p2)
    order = tree.tri_order
    packed = pbvh.pack(tree, p0[order], (p1 - p0)[order], (p2 - p0)[order],
                       order.astype(np.int32))
    maps, root = pbvh.build_wide_maps(tree)
    tables = dict(nodes=pbvh.assemble_wide(packed.nodes, maps.child_src), meta=maps.meta,
                  records=packed.records[maps.leaf_ids], words=packed.words[maps.leaf_ids],
                  root=root, stack_bound=pbvh.wide_stack_bound(maps.meta, root))
    return tables, packed


def test_ref_matches_xla_on_mesh():
    """Closed mesh (shared edges): the same triangle wins, or an equally
    close one where a ray crosses an edge."""
    tables, packed = _mesh_tables()
    o, d, tmn, tmx = [np.asarray(x) for x in _random_rays(512, 19, coherent=True)]
    jpacked = jbvh.PackedBVH(nodes=jnp.asarray(packed.nodes), records=jnp.asarray(packed.records),
                             words=jnp.asarray(packed.words), n_nodes=packed.n_nodes)
    want = jbvh.intersect_closest_p(jpacked, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmn),
                                    jnp.asarray(tmx), cull_sign=1)
    t, w, _, _ = [x.numpy() for x in _ref(tables, o, d, tmn, tmx, False, 1, 0)]
    ref_tri, ref_t = np.asarray(want.tri), np.asarray(want.t)
    np.testing.assert_array_equal(w >= 0, ref_tri >= 0)
    hit = ref_tri >= 0
    assert hit.sum() > 100
    np.testing.assert_allclose(t[hit], ref_t[hit], rtol=1e-6)
    same = (w == ref_tri) | (np.abs(t - ref_t) <= 1e-6 * np.abs(ref_t))
    assert same.all()


def _brute_force(tables, o, d, tmn, tmx, cull, blend, any_lane):
    """Every triangle of the leaf tables against every ray, in numpy f32 with
    the kernel's predicate, order-free. Returns (t, accepted) per (ray,
    triangle), with t = inf where the triangle is not accepted."""
    f = np.float32
    rec = tables["records"].reshape(-1, 9)[None]  # (1, T, 9)
    word = tables["words"].reshape(-1)[None]
    o, d = o[:, None, :].astype(f), d[:, None, :].astype(f)
    e1, e2 = rec[..., 3:6], rec[..., 6:9]
    pv = np.stack([d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1],
                   d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2],
                   d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]], -1)
    det = e1[..., 0] * pv[..., 0] + e1[..., 1] * pv[..., 1] + e1[..., 2] * pv[..., 2]
    det_ok = np.abs(det) > f(1e-12)
    with np.errstate(divide="ignore"):
        inv_det = np.where(det_ok, f(1) / np.where(det_ok, det, f(1)), f(0))
    tv = o - rec[..., 0:3]
    uu = (tv[..., 0] * pv[..., 0] + tv[..., 1] * pv[..., 1] + tv[..., 2] * pv[..., 2]) * inv_det
    qv = np.stack([tv[..., 1] * e1[..., 2] - tv[..., 2] * e1[..., 1],
                   tv[..., 2] * e1[..., 0] - tv[..., 0] * e1[..., 2],
                   tv[..., 0] * e1[..., 1] - tv[..., 1] * e1[..., 0]], -1)
    vv = (d[..., 0] * qv[..., 0] + d[..., 1] * qv[..., 1] + d[..., 2] * qv[..., 2]) * inv_det
    tt = (e2[..., 0] * qv[..., 0] + e2[..., 1] * qv[..., 1] + e2[..., 2] * qv[..., 2]) * inv_det
    ok = (det_ok & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > tmn[:, None])
          & (tt < tmx[:, None]) & (word >= 0))
    if blend == jbvh.BLEND_EXCLUDE:
        ok &= (word & jbvh.FLAG_BLEND) == 0
    elif blend == jbvh.BLEND_ONLY:
        ok &= (word & jbvh.FLAG_BLEND) != 0
    if cull:
        ok &= ~((det * f(cull) < 0) & ((word & jbvh.FLAG_DOUBLE_SIDED) == 0)
                & ~any_lane[:, None])
    return np.where(ok, tt, np.inf), ok


@pytest.mark.parametrize("fixture", ["soup", "mesh"])
@pytest.mark.parametrize("cull", [-1, 0, 1])
@pytest.mark.parametrize("blend", [jbvh.BLEND_ANY, jbvh.BLEND_EXCLUDE, jbvh.BLEND_ONLY])
def test_ref_matches_brute_force(soup, fixture, cull, blend):
    """Nearest-child-first traversal against every triangle tested, which
    no visit order can change: closest lanes report the smallest accepted
    t (1e-6 relative) and its triangle's word (any of them where several
    tie on that t, which only shared mesh edges do), any-hit lanes whether
    any triangle is accepted."""
    if fixture == "soup":
        tables = soup
        o, d, tmn, tmx = _ray_families(soup, seed=29)
    else:
        tables, _ = _mesh_tables()
        o, d, tmn, tmx = [np.asarray(x) for x in _random_rays(256, 31, coherent=True)]
    mode = (np.random.default_rng(37).random(o.shape[0]) < 0.3).astype(np.int32)
    t_all, ok = _brute_force(tables, o, d, tmn, tmx, cull, blend, mode > 0)
    t, w, _, _ = [x.numpy() for x in _ref(tables, o, d, tmn, tmx, "lane", cull, blend, mode)]
    closest = mode == 0
    best = t_all.min(1)
    hit = np.isfinite(best)
    np.testing.assert_array_equal(w[closest] >= 0, hit[closest])
    np.testing.assert_allclose(t[closest & hit], best[closest & hit], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t[closest & ~hit], tmx[closest & ~hit])
    words = tables["words"].reshape(-1)
    ties = (t_all == best[:, None]) & hit[:, None]
    for r in np.nonzero(closest & hit)[0]:
        assert w[r] in words[ties[r]]
    if fixture == "soup":
        assert (ties.sum(1) <= 1).all()
    np.testing.assert_array_equal(w[~closest] >= 0, ok[~closest].any(1))
    if blend != jbvh.BLEND_ONLY or fixture == "soup":  # the mesh has no BLEND triangle
        assert (closest & hit).any() and (~closest & hit).any()


def test_stack_bound_covers_every_push(soup):
    """The bound holds for the worst case (every box hit): the plain version
    indexes its (R, stack_bound) stack and would raise past it."""
    bound = soup["stack_bound"]
    assert bound >= 4
    o = np.zeros((64, 3), np.float32)
    d = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _ref(soup, o, d, np.zeros(64, np.float32), np.full(64, 50.0, np.float32))


def test_wrapper_routes_cpu_to_plain_and_validates(soup):
    T = lambda x: torch.from_numpy(np.array(x))
    o, d, tmn, tmx = [np.asarray(x) for x in _random_rays(32, 23)]
    args = [T(soup[k]) for k in ("nodes", "meta", "records", "words")] + [T(o), T(d), T(tmn)]
    launches, calls = tr.KERNEL_LAUNCHES, tr.REFERENCE_CALLS
    out = tr.traverse_wide(*args, T(tmx), soup["root"], stack_bound=soup["stack_bound"])
    assert tr.KERNEL_LAUNCHES == launches and tr.REFERENCE_CALLS == calls + 1
    ref = _ref(soup, o, d, tmn, tmx)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tr.traverse_wide(*args, T(tmx), soup["root"], any_hit="lane",
                         stack_bound=soup["stack_bound"])
    with pytest.raises(TypeError):
        tr.traverse_wide(*args[:4], T(o).double(), *args[5:], T(tmx), soup["root"],
                         stack_bound=soup["stack_bound"])
