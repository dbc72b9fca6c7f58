"""Torch port shading vs the JAX package on fixed hits.

Both packages read the same tables (the JAX PTScene carried across with
convert.from_jax_pt_scene). Each stage gets the same inputs, the JAX
stage's outputs feeding the next stage on both sides, so a difference is
attributed to one function: fetch_hit_attributes, get_surface_properties,
evaluate_bsdf, sample_bsdf, env_sample and env_pdf. Floats agree to 1e-5
relative plus 1e-6 absolute (for values near zero); ids, masks and
booleans exactly. sample_bsdf's bsdf and pdf are evaluated at the direction
it sampled, through sin/cos whose last bits differ between XLA and torch;
the GGX lobe (roughness^2 0.2) magnifies that (measured 2.5e-5 relative),
so those two agree to 1e-4 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gltf_renderer_tpu.env import environment as jenv_ops
from gltf_renderer_tpu.ops import material as jmat
from gltf_renderer_tpu.render import pathtracer as jpt
from gltf_renderer_tpu_torch import convert
from gltf_renderer_tpu_torch.env import environment as penv_ops
from gltf_renderer_tpu_torch.ops import material as pmat
from gltf_renderer_tpu_torch.ops.bsdf import SurfaceProperties
from gltf_renderer_tpu_torch.render import pathtracer as ppt
from tests.test_torch_scene import build_jax_bench_scene, jax_knobs, jax_settings, port_settings

torch.set_num_threads(2)
R = 512
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    import jax

    with pytest.MonkeyPatch.context() as mp:
        jax_knobs(mp)
        _, _, jscene, jmeta = build_jax_bench_scene(str(tmp_path_factory.mktemp("shade")))
    pscene, pmeta = convert.from_jax_pt_scene(jax.tree.map(np.asarray, jscene), jmeta, "cpu")
    return jscene, jmeta, pscene, pmeta


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


def _unit(rs, n):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _hits(jscene):
    """Fixed hits on triangles a ray can hit: the sphere's pole triangles
    have zero area (no ray passes their |det| > 1e-12 test), and their
    normals are rounding noise in either package."""
    rs = np.random.default_rng(0)
    pos = np.asarray(jscene.world.position)
    tv = np.asarray(jscene.world.tri_vertex)
    e1 = pos[tv[:, 1]] - pos[tv[:, 0]]
    e2 = pos[tv[:, 2]] - pos[tv[:, 0]]
    area = np.linalg.norm(np.cross(e1, e2), axis=-1)
    scale = np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1)
    hittable = np.nonzero(area > 1e-3 * scale)[0]
    tri = rs.choice(hittable, R).astype(np.int32)
    tri[:8] = -1  # miss lanes are fetched too (then masked out)
    uv = rs.random((R, 2)).astype(np.float32)
    flip = uv.sum(-1) > 1.0
    uv[flip] = 1.0 - uv[flip]
    return tri, uv[:, 0].copy(), uv[:, 1].copy(), _unit(rs, R)


def _jax_sp_inputs(jscene, jmeta):
    tri, u, v, d = _hits(jscene)
    attrs = jpt.fetch_hit_attributes(jscene.world, jnp.asarray(tri), jnp.asarray(u),
                                     jnp.asarray(v), jnp.asarray(d))
    return tri, u, v, d, attrs


def _jax_surface(jscene, jmeta, attrs, d):
    return jmat.get_surface_properties(
        jscene.materials, jscene.textures, attrs.material, attrs.uv0, attrs.uv1, attrs.color,
        attrs.normal, attrs.tangent, attrs.bitangent, attrs.geometric_normal, -jnp.asarray(d),
        used_slots=jmeta.used_slots, rows_compact=True, identity_uv=jmeta.identity_uv,
        wrap_modes=jmeta.wrap_modes, any_nearest=jmeta.any_nearest)


def test_fetch_hit_attributes(scenes):
    jscene, jmeta, pscene, _ = scenes
    tri, u, v, d, want = _jax_sp_inputs(jscene, jmeta)
    got = ppt.fetch_hit_attributes(pscene.world, _t(tri).long(), _t(u), _t(v), _t(d))
    assert got.uv_area_ratio is None and want.uv_area_ratio is None  # no footprint asked
    for f in got._fields[:-1]:
        _close(getattr(got, f), getattr(want, f))


def test_get_surface_properties(scenes):
    jscene, jmeta, pscene, pmeta = scenes
    _, _, _, d, attrs = _jax_sp_inputs(jscene, jmeta)
    want_sp, want_ex = _jax_surface(jscene, jmeta, attrs, d)
    got_sp, got_ex = pmat.get_surface_properties(
        pscene.materials, pscene.textures, _t(attrs.material), _t(attrs.uv0), _t(attrs.uv1),
        _t(attrs.color), _t(attrs.normal), _t(attrs.tangent), _t(attrs.bitangent),
        _t(attrs.geometric_normal), -_t(d), used_slots=pmeta.used_slots,
        identity_uv=pmeta.identity_uv, wrap_modes=pmeta.wrap_modes,
        any_nearest=pmeta.any_nearest)
    for f in SurfaceProperties._fields:
        _close(getattr(got_sp, f), getattr(want_sp, f))
    for f in got_ex._fields:
        _close(getattr(got_ex, f), getattr(want_ex, f))


def _shared_sp(jscene, jmeta):
    _, _, _, d, attrs = _jax_sp_inputs(jscene, jmeta)
    want_sp, _ = _jax_surface(jscene, jmeta, attrs, d)
    port_sp = SurfaceProperties(*[_t(x) for x in want_sp])
    return want_sp, port_sp, attrs, d


def test_evaluate_bsdf(scenes):
    jscene, jmeta, _, pmeta = scenes
    want_sp, port_sp, attrs, d = _shared_sp(jscene, jmeta)
    l = _unit(np.random.default_rng(1), R)
    jset, _ = jax_settings()
    pset, _ = port_settings()
    f, pdf = jpt.evaluate_bsdf(want_sp, attrs.geometric_normal, -jnp.asarray(d), jnp.asarray(l),
                               jset, None, meta=jmeta)
    gf, gpdf = ppt.evaluate_bsdf(port_sp, _t(attrs.geometric_normal), -_t(d), _t(l), pset, pmeta)
    _close(gf, f)
    _close(gpdf, pdf)
    assert (np.asarray(f) > 0).any()


def test_sample_bsdf(scenes):
    jscene, jmeta, _, pmeta = scenes
    want_sp, port_sp, _, d = _shared_sp(jscene, jmeta)
    u3 = np.random.default_rng(2).random((R, 3)).astype(np.float32)
    jset, _ = jax_settings()
    pset, _ = port_settings()
    want = jpt.sample_bsdf(want_sp, jnp.asarray(u3), -jnp.asarray(d), jset, None, meta=jmeta)
    f, l, pdf, is_t, use_mis = ppt.sample_bsdf(port_sp, _t(u3), -_t(d), pset, pmeta)
    _close(l, want[1])
    _close(is_t, want[3])
    _close(use_mis, want[4])
    _close(f, want[0], rtol=1e-4)
    _close(pdf, want[2], rtol=1e-4)


def test_env_sample_and_pdf(scenes):
    jscene, _, pscene, _ = scenes
    rs = np.random.default_rng(3)
    u4 = rs.random((R, 4)).astype(np.float32)
    want = jenv_ops.env_sample(jscene.env, jnp.asarray(u4))
    got = penv_ops.env_sample(pscene.env, _t(u4))
    for g, w in zip(got, want):
        _close(g, w)
    dirs = _unit(rs, R)
    _close(penv_ops.env_pdf(pscene.env, _t(dirs)), jenv_ops.env_pdf(jscene.env, jnp.asarray(dirs)))
    _close(penv_ops.env_radiance(pscene.env, _t(dirs)),
           jenv_ops.env_radiance(jscene.env, jnp.asarray(dirs)))


def _sampler_cases():
    from gltf_renderer_tpu.ops import sampling as js
    from gltf_renderer_tpu.utils import math as jm
    from gltf_renderer_tpu_torch.ops import sampling as ps
    from gltf_renderer_tpu_torch.utils import math as pm

    rs = np.random.default_rng(4)
    u = rs.random((R, 2)).astype(np.float32)
    n = _unit(rs, R)
    h = _unit(rs, R)
    h[:, 2] = np.abs(h[:, 2])
    a2 = rs.uniform(0.05, 1.0, (R, 2)).astype(np.float32)
    a = a2[:, 0].copy()
    return {
        "sample_ggx_normal": (lambda: js.sample_ggx_normal(jnp.asarray(a), jnp.asarray(u)),
                              lambda: ps.sample_ggx_normal(_t(a), _t(u))),
        "ggx_normal_pdf": (lambda: js.ggx_normal_pdf(jnp.asarray(a), jnp.asarray(n), jnp.asarray(h)),
                           lambda: ps.ggx_normal_pdf(_t(a), _t(n), _t(h))),
        "sample_ggx_anisotropic_normal": (
            lambda: js.sample_ggx_anisotropic_normal(jnp.asarray(a2), jnp.asarray(u)),
            lambda: ps.sample_ggx_anisotropic_normal(_t(a2), _t(u))),
        "ggx_anisotropic_normal_pdf": (
            lambda: js.ggx_anisotropic_normal_pdf(jnp.asarray(a2), jnp.asarray(h)),
            lambda: ps.ggx_anisotropic_normal_pdf(_t(a2), _t(h))),
        "sample_ggx_visible_normal": (
            lambda: js.sample_ggx_visible_normal(jnp.asarray(a2), jnp.asarray(h), jnp.asarray(u)),
            lambda: ps.sample_ggx_visible_normal(_t(a2), _t(h), _t(u))),
        "sample_cosine_hemisphere": (
            lambda: js.sample_cosine_hemisphere(jnp.asarray(n), jnp.asarray(u)),
            lambda: ps.sample_cosine_hemisphere(_t(n), _t(u))),
        "create_basis": (lambda: jm.create_basis(jnp.asarray(n)),
                         lambda: pm.create_basis(_t(n))),
    }


@pytest.mark.parametrize("name", list(_sampler_cases()))
def test_samplers(name):
    want_fn, got_fn = _sampler_cases()[name]
    want, got = want_fn(), got_fn()
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)
