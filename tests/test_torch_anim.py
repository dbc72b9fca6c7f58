"""Animation, skinning / morph targets and the BVH refit of the port against
the JAX package, and the anim_pose golden.

Tolerances, and why:
- Channel sampling, poses, bone palettes and node transforms: none (both
  are the same host numpy code).
- Skinning: the JAX package jits `skin_primitive` on XLA:CPU, which
  contracts multiply-adds; the port rounds each op. Before the codec,
  positions agree within 4e-7 relative to the largest coordinate
  (measured up to 1.4e-7 over 39 poses of each scene). After the
  10:10:10:2 codec a last-bit difference can move a vertex by one codec
  level: at most MAX_CODEC_STEPS vertices of a scene may differ, each by
  at most one level (4e-3 in a unit normal); the rest must be within 2e-6
  (measured: no vertex moved in those 39 poses).
- The world build from dynamic pools: none, given the same pools (the
  port's matvec rounds as XLA's fused one, as for static scenes).
- Refit and pack_update: boxes by `==` with no NaN (min / max are exact;
  only the sign of a zero may differ between XLA and torch), records bit
  for bit. `refit_pt_scene` gives the closest t of a fresh build at the
  same pose on every ray, and the same triangle on all but exact-t ties.
- The golden: SSIM >= 0.99 against tests/goldens/anim_pose.png (measured
  0.99999892).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gltf_renderer_tpu.anim import animation as janim
from gltf_renderer_tpu.anim import skinning as jskin
from gltf_renderer_tpu.ops import bvh as jbvh
from gltf_renderer_tpu.scene import flatten as jflat
from gltf_renderer_tpu.scene import procedural as jproc
from gltf_renderer_tpu.scene.gltf import load_gltf as jax_load_gltf
from gltf_renderer_tpu.utils import math as jmath
from gltf_renderer_tpu_torch import bench_scene
from gltf_renderer_tpu_torch.anim import animation as panim
from gltf_renderer_tpu_torch.anim import skinning as pskin
from gltf_renderer_tpu_torch.ops import bvh as pbvh
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from gltf_renderer_tpu_torch.scene import flatten as pflat
from gltf_renderer_tpu_torch.scene.gltf import load_gltf
from gltf_renderer_tpu_torch.utils import math as pmath
from gltf_renderer_tpu_torch.utils.ssim import ssim
from tests.test_torch_loader import _kitchen_sink

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "anim_pose.png")
MAX_CODEC_STEPS = 2    # dynamic vertices a scene may have one codec level apart
CODEC_STEP = 4e-3      # one 10-bit octahedral level in a unit normal, with margin
POSITION_RTOL = 4e-7   # skinned positions / normals, relative to the largest value


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("anim"))
    return {
        "camera": jproc.write_camera_anim_gltf(os.path.join(d, "cam.gltf")),
        "skinned": jproc.write_skinned_gltf(os.path.join(d, "skin.gltf"), strips=3),
        "morph": jproc.write_morph_gltf(os.path.join(d, "morph.gltf")),
        "sink": _kitchen_sink(os.path.join(d, "sink.gltf")),
    }


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_pose(p, j):
    for f in ("t", "r", "s"):
        _eq(getattr(p, f), getattr(j, f))
    assert sorted(p.weights) == sorted(j.weights)
    for k in p.weights:
        _eq(p.weights[k], j.weights[k])


@pytest.mark.parametrize("name", ["camera", "skinned", "morph", "sink"])
def test_player_poses_match_jax(name, files):
    """AnimationPlayer.tick over steps that cross the loop point, every
    channel of every animation sampled: poses identical."""
    ps, js = load_gltf(files[name]), jax_load_gltf(files[name])
    for p_anim, j_anim in zip(ps.animations, js.animations):
        pp, jp = panim.AnimationPlayer(p_anim), janim.AnimationPlayer(j_anim)
        for delta in (0.0, 0.3, 0.45, 0.7, 0.9, 0.05, 1.3):
            _same_pose(pp.tick(ps, delta), jp.tick(js, delta))
            assert pp.time == jp.time
        for ch_p, ch_j in zip(p_anim.channels, j_anim.channels):
            for t in (-1.0, 0.0, 0.25, 0.5, 1.0, 1.2, 1.5, 5.0):
                _eq(panim.sample_channel(ch_p, t), janim.sample_channel(ch_j, t))
    _same_pose(panim.rest_pose(ps), janim.rest_pose(js))


def test_loop_wraps_the_playhead(files):
    """Past the duration the playhead wraps (the skinned strip: 2 s)."""
    scene = load_gltf(files["skinned"])
    player = panim.AnimationPlayer(scene.animations[0])
    player.tick(scene, 1.5)
    player.tick(scene, 0.75)
    assert abs(player.time - 0.25) < 1e-12
    player.looping = False
    player.tick(scene, 2.0)
    assert player.time == 2.25


@pytest.mark.parametrize("name", ["camera", "skinned", "sink"])
def test_posed_transforms_and_bones_match_jax(name, files):
    ps, js = load_gltf(files[name]), jax_load_gltf(files[name])
    for t in (0.4, 1.1):
        pose = panim.animate(ps, ps.animations[0], t)
        tf = pflat.compute_global_transforms(ps, None, pose.t, pose.r, pose.s)
        _eq(tf, jflat.compute_global_transforms(js, None, pose.t, pose.r, pose.s))
        for node in ps.nodes:
            if node.skin >= 0:
                mesh_tf = tf[ps.nodes.index(node)]
                for a, b in zip(pskin.compute_bones(tf, ps.skins[node.skin], mesh_tf),
                                jskin.compute_bones(tf, js.skins[node.skin], mesh_tf)):
                    _eq(a, b)


def test_top_morph_targets_match_jax():
    rs = np.random.RandomState(1)
    for n in (1, 3, 4, 7):
        w = rs.uniform(-0.5, 1.0, n).astype(np.float32)
        for a, b in zip(pskin.select_top_morph_targets(w), jskin.select_top_morph_targets(w)):
            _eq(a, b)


def test_tangent_codecs_match_jax():
    """encode / decode / unpack against the JAX codec on random unit frames:
    words equal but for last-bit level flips (counted), decoded frames
    within float32 rounding of the JAX ones."""
    rs = np.random.RandomState(4)
    n = rs.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = np.cross(n, rs.normal(size=(4096, 3))).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    t4 = np.concatenate([t, np.where(rs.rand(4096, 1) < 0.5, 1.0, -1.0)], 1).astype(np.float32)
    pw = pmath.encode_tangent_space(torch.as_tensor(n), torch.as_tensor(t4)).numpy()
    jw = np.asarray(jmath.encode_tangent_space(jnp.asarray(n), jnp.asarray(t4))).astype(np.int64)
    assert (pw != jw).sum() <= 8  # measured 0-2: one 10-bit field one level apart
    pn, pt = pmath.decode_tangent_space(pmath.unpack_r10g10b10a2(torch.as_tensor(jw)))
    jn, jt = jmath.decode_tangent_space(jmath.unpack_r10g10b10a2(jnp.asarray(jw, jnp.uint32)))
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=0, atol=2e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=2e-6)
    _eq(pmath.unpack_r10g10b10a2(torch.as_tensor(jw)).numpy(),
        np.asarray(jmath.unpack_r10g10b10a2(jnp.asarray(jw, jnp.uint32))))
    # NaN frames encode like XLA's saturating convert (NaN -> 0), not -2^31.
    bad = torch.full((1, 3), float("nan"))
    assert int(pmath.encode_tangent_space(bad, torch.cat([bad, torch.ones(1, 1)], 1))) >= 0


def _dynamic_pair(name, files, t):
    """(port DynamicMeshState, JAX DynamicMeshState, node transforms) both
    updated to time t of the first animation."""
    ps, js = load_gltf(files[name]), jax_load_gltf(files[name])
    pose = panim.animate(ps, ps.animations[0], t)
    tf = pflat.compute_global_transforms(ps, None, pose.t, pose.r, pose.s)
    p_state, j_state = pskin.DynamicMeshState(ps, "cpu"), jskin.DynamicMeshState(js)
    assert p_state.dynamic_instances == j_state.dynamic_instances
    p_state.update(tf, pose.weights)
    j_state.update(tf, pose.weights)
    return ps, js, p_state, j_state, tf


@pytest.mark.parametrize("name", ["skinned", "morph", "sink"])
def test_skinning_matches_jax(name, files):
    """DynamicMeshState.update against JAX's on every vertex: within the
    stated tolerance before the codec, codec levels equal on all but
    MAX_CODEC_STEPS vertices.

    The sink's strip primitive has no JOINTS_0 / WEIGHTS_0 on a skinned
    node (not valid glTF): its zero weights skin every vertex to the
    origin with a zero normal and tangent, which neither package defines a
    direction for (the codec reads 0 / 0); those vertices are held to the
    origin in both and to finite values in the port, and left out of the
    direction comparison."""
    for t in (0.5, 1.3):
        ps, _, p_state, j_state, _ = _dynamic_pair(name, files, t)
        pos, jpos = p_state.positions.numpy(), np.asarray(j_state.positions)
        scale = np.abs(jpos).max()
        assert np.abs(pos - jpos).max() <= POSITION_RTOL * scale
        undefined = np.zeros(len(pos), bool)
        for node_id, prim in p_state.dynamic_instances:
            if ps.nodes[node_id].skin >= 0 and not ps.primitives.has_joints[prim]:
                vo = ps.primitives.vertex_offset[prim]
                undefined[vo:vo + ps.primitives.vertex_count[prim]] = True
        assert (pos[undefined] == 0).all() and (jpos[undefined] == 0).all()
        assert torch.isfinite(p_state.normals).all() and torch.isfinite(p_state.tangents).all()
        for got, want in ((p_state.normals, j_state.normals),
                          (p_state.tangents, j_state.tangents)):
            diff = np.abs(got.numpy() - np.asarray(want)).max(-1)[~undefined]
            moved = diff > 2e-6
            assert moved.sum() <= MAX_CODEC_STEPS, (name, t, int(moved.sum()))
            assert diff.max() <= CODEC_STEP


def _per_primitive_update(scene, state, node_global, pose_weights):
    """The JAX package's DynamicMeshState.update loop, one skin_primitive
    call a (node, primitive), with the port's skin_primitive."""
    pools, prim = scene.pools, scene.primitives
    k = pskin.MAX_SIMULTANEOUS_MORPH_TARGETS
    out = [torch.as_tensor(np.array(x)) for x in (pools.positions, pools.normals,
                                                   pools.tangents)]
    for node_id, p in state.dynamic_instances:
        node = scene.nodes[node_id]
        vo, vc = int(prim.vertex_offset[p]), int(prim.vertex_count[p])
        n_targets, mo = int(prim.morph_count[p]), int(prim.morph_offset[p])
        weights = pose_weights.get(node_id)
        if weights is None or len(weights) == 0 or n_targets == 0:
            sel_i, sel_w = np.zeros(k, np.int32), np.zeros(k, np.float32)
        else:
            sel_i, sel_w = pskin.select_top_morph_targets(weights[:n_targets])
        if n_targets:
            morph = [np.stack([m[mo + i * vc:mo + (i + 1) * vc] for i in sel_i])
                     for m in (pools.morph_pos, pools.morph_normal, pools.morph_tangent)]
        else:
            morph = [np.zeros((k, vc, 3), np.float32)] * 3
        if node.skin >= 0:
            bones, bones_it = pskin.compute_bones(node_global, scene.skins[node.skin],
                                                  node_global[node_id])
        else:
            bones = bones_it = np.eye(4, dtype=np.float32)[None]
        r = slice(vo, vo + vc)
        got = pskin.skin_primitive(
            *[torch.as_tensor(np.array(x[r])) for x in (pools.positions, pools.normals,
                                                         pools.tangents)],
            torch.as_tensor(np.clip(pools.joints[r], 0, len(bones) - 1)).long(),
            torch.as_tensor(np.array(pools.weights[r])), torch.as_tensor(bones),
            torch.as_tensor(bones_it), *[torch.as_tensor(m) for m in morph],
            torch.as_tensor(sel_w), node.skin >= 0, bool(prim.has_tangent_space[p]))
        for o, g in zip(out, got):
            o[r] = g
    return out


def _shared_morph_mesh(path):
    """The morph cube's mesh on two nodes with their own weights: the
    second write of the primitive's range wins."""
    import json

    jproc.write_morph_gltf(path)
    doc = json.load(open(path))
    doc["nodes"] = [{"mesh": 0}, {"mesh": 0, "weights": [0.7], "translation": [2, 0, 0]}]
    doc["scenes"] = [{"nodes": [0, 1]}]
    json.dump(doc, open(path, "w"))
    return path


@pytest.mark.parametrize("name", ["skinned", "morph", "sink", "shared"])
def test_batched_update_is_the_per_primitive_loop(name, files, tmp_path):
    """DynamicMeshState.update skins every vertex in one call; the JAX
    package's per-(node, primitive) loop gives the same bits."""
    path = _shared_morph_mesh(str(tmp_path / "shared.gltf")) if name == "shared" \
        else files[name]
    scene = load_gltf(path)
    state = pskin.DynamicMeshState(scene, "cpu")
    for t in (0.3, 0.8, 1.6):
        pose = panim.animate(scene, scene.animations[0], t)
        tf = pflat.compute_global_transforms(scene, None, pose.t, pose.r, pose.s)
        state.update(tf, pose.weights)
        want = _per_primitive_update(scene, state, tf, pose.weights)
        for got, w in zip((state.positions, state.normals, state.tangents), want):
            assert got.numpy().tobytes() == w.numpy().tobytes()


def test_skinning_without_tangent_space_skips_the_codec():
    """A primitive without NORMAL skins to unit vectors not re-quantised,
    as the JAX skin_primitive's has_ts branch."""
    rs = np.random.RandomState(2)
    v = 12
    args = [rs.rand(v, 3).astype(np.float32), rs.normal(size=(v, 3)).astype(np.float32),
            np.concatenate([rs.normal(size=(v, 3)), np.ones((v, 1))], 1).astype(np.float32),
            rs.randint(0, 2, (v, 4)), rs.dirichlet(np.ones(4), v).astype(np.float32)]
    bones = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    bones[1, :3, 3] = [0.5, -0.25, 1.0]
    bones[1, :3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 2]]
    bones_it = bones.copy()
    bones_it[1, :3, :3] = np.linalg.inv(bones[1, :3, :3]).T
    bones_it[:, :3, 3] = 0
    morph = [np.zeros((4, v, 3), np.float32)] * 3
    w = np.zeros(4, np.float32)
    got = pskin.skin_primitive(*[torch.as_tensor(a) for a in args[:3]],
                               torch.as_tensor(args[3]).long(), torch.as_tensor(args[4]),
                               torch.as_tensor(bones), torch.as_tensor(bones_it),
                               *[torch.as_tensor(m) for m in morph], torch.as_tensor(w),
                               True, False)
    want = jskin.skin_primitive(*args, bones, bones_it, *morph, w, True, False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["skinned", "sink"])
def test_world_from_dynamic_pools_matches_jax(name, files):
    """build_world_geometry with dynamic pools: tensors, bit-identical to
    the JAX build from the same pools."""
    ps, js, _, j_state, tf = _dynamic_pair(name, files, 0.6)
    plan = pflat.build_instance_plan(ps)
    flags = pflat.plan_tri_flags(plan, ps.primitives)
    dyn = [torch.as_tensor(np.array(x)) for x in
           (j_state.positions, j_state.normals, j_state.tangents)]
    got = pflat.build_world_geometry(ps.pools, plan, tf, pflat.normal_transforms(tf), flags,
                                     *dyn)
    jplan = jflat.build_instance_plan(js)
    want = jflat.build_world_geometry(
        jax_pools(js), jplan, jnp.asarray(tf), jnp.asarray(jflat.normal_transforms(tf)),
        jflat.plan_tri_flags(jplan, js.primitives), j_state.positions, j_state.normals,
        j_state.tangents)
    assert isinstance(got.position, torch.Tensor)
    for f in ("position", "normal", "tangent", "vertex_rows", "tri_rows", "tri_attr_rows"):
        _eq(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def jax_pools(scene):
    return scene.pools._replace(**{k: jnp.asarray(v) for k, v in scene.pools._asdict().items()})


def _soup(n, seed):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    return [c + rs.uniform(-0.1, 0.1, (n, 3)).astype(np.float32) for _ in range(3)]


def _boxes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert not np.isnan(a).any() and not np.isnan(b).any()
    assert a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("n", [5, 300, 3000])
def test_refit_and_pack_update_match_jax(n):
    """Tree built on one triangle soup, refit to a moved one (a single leaf,
    a few levels, a dozen levels): boxes ==, records and nodes' columns
    6-7 bit for bit, the tensor assemble_wide the numpy one's bits."""
    p0, p1, p2 = _soup(n, 3)
    tree = pbvh.build(p0, p1, p2)
    order = tree.tri_order
    words = order.astype(np.int32)
    packed = pbvh.pack(tree, p0[order], (p1 - p0)[order], (p2 - p0)[order], words)
    q = [p + np.random.RandomState(9).normal(0, 0.05, p.shape).astype(np.float32)
         for p in (p0, p1, p2)]
    got = pbvh.refit(tree, *[torch.as_tensor(x) for x in q])
    want = jbvh.refit(tree, *[jnp.asarray(x) for x in q])
    _boxes_equal(got.aabb_min, want.aabb_min)
    _boxes_equal(got.aabb_max, want.aabb_max)
    s = [torch.as_tensor(x) for x in (q[0][order], (q[1] - q[0])[order], (q[2] - q[0])[order])]
    pk = pbvh.pack_update(packed, tree, *s, refitted=got)
    jpk = jbvh.pack_update(jbvh.PackedBVH(jnp.asarray(packed.nodes), jnp.asarray(packed.records),
                                          jnp.asarray(packed.words), packed.n_nodes),
                           tree, *[jnp.asarray(x.numpy()) for x in s], refitted=want)
    _eq(pk.records.numpy(), np.asarray(jpk.records))
    _boxes_equal(pk.nodes.numpy(), np.asarray(jpk.nodes))
    _eq(pk.nodes.numpy()[:, 6:], packed.nodes[:, 6:])
    # At the build's own positions the refit gives the build's boxes and
    # pack_update the build's tables.
    same = pbvh.refit(tree, *[torch.as_tensor(x) for x in (p0, p1, p2)])
    _boxes_equal(same.aabb_min.numpy(), tree.aabb_min)
    _boxes_equal(same.aabb_max.numpy(), tree.aabb_max)
    s0 = [torch.as_tensor(x) for x in (p0[order], (p1 - p0)[order], (p2 - p0)[order])]
    pk0 = pbvh.pack_update(packed, tree, *s0, refitted=same)
    _eq(pk0.records.numpy(), packed.records)
    maps, _ = pbvh.build_wide_maps(tree)
    _eq(pbvh.assemble_wide(pk.nodes, maps.child_src).numpy(),
        pbvh.assemble_wide(pk.nodes.numpy(), maps.child_src))


def test_refit_pt_scene_matches_a_fresh_build():
    """The skinned strips built at rest then refit to t = 0.7, against a
    build at t = 0.7: every PTScene table that depends on positions equals
    the fresh build's where the topology allows (world, lights, records),
    and primary rays find the same closest t, and the same triangle but
    on exact-t ties."""
    refit, settings, params, _ = bench_scene.build_animated_scene("skinned", 64, 48, "cpu",
                                                                  strips=8)
    refit.update(0.7)
    fresh, *_ = bench_scene.build_animated_scene("skinned", 64, 48, "cpu", strips=8, time=0.7)
    a, b = refit.ptscene, fresh.ptscene
    for f in a.world._fields:
        _eq(getattr(a.world, f).numpy(), getattr(b.world, f).numpy())
    assert isinstance(a.packed.records, torch.Tensor)
    c2w = bench_scene.anim_camera("skinned", 64, 48, bench_scene.ANIM_GOLDEN_VIEWS)
    from gltf_renderer_tpu_torch.render import rasterizer as rz

    px, py = torch.meshgrid(torch.arange(64), torch.arange(48), indexing="xy")
    o, d, t_max = rz._pixel_rays(px.reshape(-1), py.reshape(-1), (64, 48),
                                 torch.as_tensor(c2w))
    zero = torch.zeros_like(t_max)
    ha = ppt.closest_hit(a, refit.meta, o, d, zero, t_max)
    hb = ppt.closest_hit(b, fresh.meta, o, d, zero, t_max)
    assert int((hb.tri >= 0).sum()) > 100
    _eq(ha.t.numpy(), hb.t.numpy())
    assert int((ha.tri != hb.tri).sum()) <= 4  # rays through a shared edge


def test_dynamic_state_stays_on_its_device(files):
    """No CPU fallback: without a card, asking for one raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    scene = load_gltf(files["morph"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pskin.DynamicMeshState(scene, "cuda")


def test_anim_pose_golden():
    img, stats = bench_scene.render_anim_pose_golden("cpu")
    golden = np.asarray(Image.open(GOLDEN))
    assert img.shape == golden.shape and float(stats[1]) == 0.0
    score = ssim(img.numpy(), golden)
    print(f"anim_pose ssim={score:.8f}")
    assert score >= 0.99
