"""The port's BSDF layers (ops/bsdf.py) against the JAX package's.

Every function of the sheen, clearcoat and thin-transmission layers, the
isotropic GGX terms they use, the Sheen_E lookup and the whole layered
`gltf_bsdf` (every combination of its layer flags, reflection-only and
masked by a transmission mask) run on the same random inputs, made from a
numpy seed, in both packages. The inputs include the edges the layers
clamp at: sheen alpha at 1e-6 (its clamp) and at 1, cos theta at 0 and 1,
ior at 1.0 (where the transmission lobe's roughness clamps to its minimum)
and 1.5.

Floats agree to 1e-5 relative plus 1e-6 absolute, the shading tests' bar
(tests/test_torch_shading.py), with NaN in the same places. XLA:CPU's pow,
exp and fused multiply-adds are not torch's, but their last-bit
differences stay under that bar, even where a GGX D at alpha^2 down to
1e-6 magnifies them, so no function needs a looser one.
The LUT, and Sheen_E on it, agree bit for bit; a NaN cos theta reads
texel 0 in both (XLA's cast of NaN), so it stays NaN only through its
weights.

Beside the JAX comparison: with every layer flag off, `gltf_bsdf`,
`layer_probabilities` and `bsdf_pdf` give the same bits on the bench
material (no sheen, clearcoat or transmission) as with the flags on, which
is why the port may skip absent layers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.ops import bsdf as jb
from gltf_renderer_tpu_torch.ops import bsdf as pb

torch.set_num_threads(2)
N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _unit(rs, n):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _alpha(rs, n=N):
    """Sheen / GGX alphas in [1e-6, 1], with both ends present exactly."""
    a = rs.uniform(1e-6, 1.0, n).astype(np.float32)
    a[:64] = 1e-6
    a[64:128] = 1.0
    return a


def _cos(rs, n=N):
    """cos theta in [0, 1], with 0 and 1 present exactly."""
    c = rs.uniform(0.0, 1.0, n).astype(np.float32)
    c[128:192] = 0.0
    c[192:256] = 1.0
    return c


def _signed(rs, n=N):
    """Dot products in [-1, 1], with 0 and +-1 present exactly."""
    c = rs.uniform(-1.0, 1.0, n).astype(np.float32)
    c[128:160] = 0.0
    c[160:192] = 1.0
    c[192:224] = -1.0
    return c


def _ior(rs, n=N):
    ior = rs.uniform(1.0, 2.5, n).astype(np.float32)
    ior[:N // 4] = 1.0
    ior[N // 4:N // 2] = 1.5
    return ior


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _run(name, *args, **kw):
    """(port result, JAX result) of ops.bsdf.<name> on the same numpy args."""
    got = getattr(pb, name)(*[torch.from_numpy(np.array(a)) for a in args], **kw)
    want = getattr(jb, name)(*[jnp.asarray(a) for a in args], **kw)
    return got, want


def _cases():
    rs = np.random.default_rng(11)
    a, cl, cv, ch = _alpha(rs), _cos(rs), _cos(rs), _cos(rs)
    s1, s2 = _signed(rs), _signed(rs)
    return {
        "ggx_smith_g1": ("ggx_smith_g1", a, cl, s1),
        "ggx_correlated_v": ("ggx_correlated_v", a, s1, s2, _signed(rs), _signed(rs)),
        "specular_brdf": ("specular_brdf", a, cl, cv, ch, s1, s2),
        "clearcoat_brdf": ("clearcoat_brdf", a, cl, cv, ch, s1, s2),
        "sheen_normal_distribution": ("sheen_normal_distribution", a, s1),
        "_sheen_l": ("_sheen_l", a, cl),
        "_sheen_shadowing": ("_sheen_shadowing", a, cl),
        "sheen_visibility": ("sheen_visibility", a, cl, cv),
        "sheen_brdf": ("sheen_brdf", a, cl, cv, ch),
        "modulate_roughness": ("modulate_roughness", a[:, None], _ior(rs)[:, None]),
        "attenuate": ("attenuate", np.where(rs.random((N, 1)) < 0.25, 0.0,
                                            rs.uniform(0.01, 2.0, (N, 1))).astype(np.float32),
                      rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32),
                      rs.uniform(0.0, 3.0, (N, 1)).astype(np.float32)),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_layer_function_matches_jax(case):
    name, *args = _cases()[case]
    got, want = _run(name, *args)
    _close(got, want)


@pytest.mark.parametrize("ior", [1.0, 1.5])
def test_fresnel_coat_matches_jax(ior):
    rs = np.random.default_rng(12)
    w = rs.uniform(0.0, 1.0, (N, 1)).astype(np.float32)
    base = rs.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    layer = rs.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    got, want = _run("fresnel_coat", ior, w, base, layer, _signed(rs)[:, None])
    _close(got, want)


def test_sheen_e_table_is_the_jax_lut():
    np.testing.assert_array_equal(pb.sheen_e_table(), jb.sheen_e_table())
    assert pb.sheen_e_table().shape == (16, 16)


def test_sheen_e_matches_jax_on_the_lut():
    rs = np.random.default_rng(13)
    a = _alpha(rs)
    c = rs.uniform(-0.2, 1.2, N).astype(np.float32)  # past both clamps
    c[:64] = 0.0
    c[64:128] = 1.0
    c[128] = np.nan
    table = pb.sheen_e_table()
    got, want = _run("sheen_e", a, c, table)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Without a table both read the committed LUT.
    got0, want0 = _run("sheen_e", a, c)
    np.testing.assert_array_equal(got0.numpy(), np.asarray(want0))
    assert np.isnan(got.numpy()[128]) and np.isfinite(np.delete(got.numpy(), 128)).all()


def test_sheen_mix_matches_jax():
    rs = np.random.default_rng(14)
    material = rs.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    layer = rs.uniform(0.0, 2.0, N).astype(np.float32)
    color = rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    color[:256] = 0.0
    got, want = _run("sheen_mix", material, layer, color, _alpha(rs), _cos(rs), _cos(rs),
                     pb.sheen_e_table())
    _close(got, want)


def _frame(rs, n=N):
    """(n, t, b): a random shading normal and an orthonormal tangent frame."""
    nrm = _unit(rs, n)
    t = np.cross(nrm, _unit(rs, n))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return nrm, t.astype(np.float32), np.cross(nrm, t).astype(np.float32)


def test_thin_transmission_btdf_matches_jax():
    rs = np.random.default_rng(15)
    nrm = _unit(rs, N)
    v = _unit(rs, N)
    v = np.where((v * nrm).sum(-1, keepdims=True) < 0, -v, v)
    l = _unit(rs, N)  # both sides: the lobe reflects l through the surface
    got, want = _run("thin_transmission_btdf", rs.uniform(0, 1, (N, 3)).astype(np.float32),
                     _alpha(rs)[:, None], _ior(rs)[:, None], nrm, v, l)
    _close(got, want)


def surface(rs, n=N):
    """Random SurfaceProperties as numpy arrays: two lanes in five each
    carry clearcoat, sheen and transmission (some all three)."""
    nrm, t, b = _frame(rs, n)

    def col(lo=0.0, hi=1.0):
        return rs.uniform(lo, hi, (n, 3)).astype(np.float32)

    def one(lo=0.0, hi=1.0):
        return rs.uniform(lo, hi, (n, 1)).astype(np.float32)

    rough = np.clip(rs.uniform(0.0, 1.0, (n, 2)) ** 2, pb.MINIMUM_ROUGHNESS, 1.0)
    rough = np.sort(rough, -1)[:, ::-1].astype(np.float32)  # tangent >= bitangent
    on = (rs.random((n, 3)) < 0.4).astype(np.float32)
    cc_n = _unit(rs, n)
    cc_n = np.where((cc_n * nrm).sum(-1, keepdims=True) < 0, -cc_n, cc_n)
    return pb.SurfaceProperties(
        albedo=col(), alpha=np.ones((n, 1), np.float32), metalness=one(),
        roughness_squared=rough, shading_normal=nrm, anisotropy_tangent=t,
        anisotropy_bitangent=b, ior=one(1.0, 2.0), specular_color=col(0.5, 1.0),
        specular_factor=one(0.5, 1.0), clearcoat=one() * on[:, 0:1],
        clearcoat_roughness=np.clip(one() ** 2, pb.MINIMUM_ROUGHNESS, 1.0),
        clearcoat_normal=cc_n.astype(np.float32), sheen_color=col() * on[:, 1:2],
        sheen_roughness_squared=np.clip(one() ** 2, pb.MINIMUM_ROUGHNESS, 1.0),
        transmissive=one() * on[:, 2:3], thickness=one(), attenuation_distance=one(),
        attenuation_color=col())


def _view_light(rs, nrm, n=N):
    v = _unit(rs, n)
    v = np.where((v * nrm).sum(-1, keepdims=True) < 0, -v, v)
    return v, _unit(rs, n)


def _sp(sp, to):
    return type(sp)(*[to(np.asarray(x)) for x in sp])


FLAGS = [dict(enable_sheen=s, enable_clearcoat=c, enable_transmission=t)
         for s in (False, True) for c in (False, True) for t in (False, True)]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join(
    k[7] if v else "-" for k, v in f.items()))
@pytest.mark.parametrize("masked", [False, True], ids=["reflect", "masked"])
def test_gltf_bsdf_matches_jax(flags, masked):
    rs = np.random.default_rng(16)
    sp = surface(rs)
    v, l = _view_light(rs, sp.shading_normal)
    is_t = rs.random(N) < 0.3 if masked else None
    table = pb.sheen_e_table()
    got = pb.gltf_bsdf(_sp(sp, torch.from_numpy), torch.from_numpy(v), torch.from_numpy(l),
                       is_transmission=None if is_t is None else torch.from_numpy(is_t),
                       sheen_table=torch.from_numpy(table), **flags)
    want = jb.gltf_bsdf(_sp(sp, jnp.asarray), jnp.asarray(v), jnp.asarray(l),
                        is_transmission=None if is_t is None else jnp.asarray(is_t),
                        sheen_table=jnp.asarray(table), **flags)
    assert np.asarray(want).max() > 0.0
    _close(got, want)


def _bench_material():
    """SurfaceProperties at fixed hits on the port's bench sphere (no
    sheen, clearcoat or transmission), views and lights, on the CPU."""
    from gltf_renderer_tpu_torch.bench_scene import world_from_scene
    from gltf_renderer_tpu_torch.ops.material import get_surface_properties
    from gltf_renderer_tpu_torch.render import pathtracer as ppt
    from gltf_renderer_tpu_torch.scene.procedural import textured_sphere_scene

    src = textured_sphere_scene(tex_size=16, n_lat=12, n_lon=24, metallic=0.3, roughness=0.45)
    world, lights = world_from_scene(src)
    scene, meta = ppt.make_pt_scene(world, src.materials, src.textures, lights, device="cpu")
    assert not (meta.has_sheen or meta.has_clearcoat or meta.has_transmission)
    rs = np.random.default_rng(17)
    n_tri = int(world.tri_vertex.shape[0])
    tri = torch.from_numpy(rs.integers(0, n_tri, 512))
    uv = rs.random((512, 2)).astype(np.float32) * 0.5
    d = torch.from_numpy(_unit(rs, 512))
    attrs = ppt.fetch_hit_attributes(scene.world, tri, torch.from_numpy(uv[:, 0]),
                                     torch.from_numpy(uv[:, 1]), d)
    sp, _ = get_surface_properties(
        scene.materials, scene.textures, attrs.material, attrs.uv0, attrs.uv1, attrs.color,
        attrs.normal, attrs.tangent, attrs.bitangent, attrs.geometric_normal, -d,
        used_slots=meta.used_slots, identity_uv=meta.identity_uv, wrap_modes=meta.wrap_modes,
        any_nearest=meta.any_nearest)
    return scene, meta, sp, -d, torch.from_numpy(_unit(rs, 512)), attrs.geometric_normal


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_absent_layers_skip_with_the_same_bits():
    """The bench material has no sheen, clearcoat or transmission: with the
    layers on it gives the bits it gives with them off. bsdf_pdf is held on
    reflection lanes: a lane flagged as transmission takes the
    transmission lobe's pdf, 0 here, where the layerless pdf is the
    reflection's; sample_bsdf never flags one (the transmission layer's
    probability is 0) and evaluate_bsdf's such lanes have a zero BSDF."""
    from gltf_renderer_tpu_torch.render import pathtracer as ppt

    scene, meta, sp, v, l, gn = _bench_material()
    on = meta._replace(has_sheen=True, has_clearcoat=True, has_transmission=True)
    is_t = (gn * l).sum(-1) * (gn * v).sum(-1) < 0.0
    for mask in (None, is_t):
        f_off = pb.gltf_bsdf(sp, v, l, is_transmission=mask, sheen_table=scene.sheen_table,
                             enable_sheen=False, enable_clearcoat=False,
                             enable_transmission=False)
        f_on = pb.gltf_bsdf(sp, v, l, is_transmission=mask, sheen_table=scene.sheen_table)
        assert torch.equal(_bits(f_off), _bits(f_on)) and float(f_on.max()) > 0.0
    p_off = ppt.layer_probabilities(sp, v, meta)
    p_on = ppt.layer_probabilities(sp, v, on)
    for a, b in zip(p_off, p_on):
        assert torch.equal(_bits(a), _bits(b))
    refl = torch.zeros(512, dtype=torch.bool)
    pdf_off = ppt.bsdf_pdf(sp, v, l, refl, p_off, meta)
    pdf_on = ppt.bsdf_pdf(sp, v, l, refl, p_on, on)
    assert torch.equal(_bits(pdf_off), _bits(pdf_on)) and float(pdf_on.max()) > 0.0
    pdf_t = ppt.bsdf_pdf(sp, v, l, is_t, p_on, on)
    assert bool(is_t.any()) and bool((pdf_t[is_t] == 0.0).all())
    assert torch.equal(_bits(pdf_t[~is_t]), _bits(pdf_off[~is_t]))
