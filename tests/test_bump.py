"""Bump-map extension: tangent frames + BumpTexture normal perturbation.

The reference STAGES bump mapping without implementing it: every intersect
computes dNdx/dNdy (intersectable.d:24-25, geometry.d:47-53, :110-122,
:227-228), Node parses ``bump`` (node.d:72-81), Bitmap.differentiate exists
(bitmap.d:139-154) and the renderer calls texture.modifyNormal at
renderer.d:370-372 — but modifyNormal is a no-op for every concrete
texture.  The repo completes the feature as the BumpTexture extension
(models/types.py) while preserving the reference's observable no-op for
every reference texture kind.

Oracle (float64 numpy) is ground truth; the f64 device path must match it
u8-exactly, like every other feature (CLAUDE.md correctness invariants).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chess2rt_tpu.models import types as T
from chess2rt_tpu.models.packed import pack_scene
from chess2rt_tpu.ops import geometry as G
from chess2rt_tpu.oracle import renderer as O
from chess2rt_tpu.oracle.renderer import render_scene
from chess2rt_tpu.render.pipeline import render_frame, render_scene_jax
from chess2rt_tpu.utils.color import srgb_u8


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _heightmap():
    hh, ww = 32, 32
    yy, xx = np.mgrid[0:hh, 0:ww]
    # smooth, low-frequency: keeps the f32-vs-f64 texel-pick knife edges
    # (different derivative texels from fp-differing UVs) a small tail
    height = (0.5 + 0.5 * np.sin(xx * 0.25) * np.cos(yy * 0.2)).astype(np.float32)
    return np.repeat(height[..., None], 3, axis=-1)


def _scene(bump=True, bump_tex_cls=T.BumpTexture, strength=8.0, mirror=False,
           bump_csg=True):
    """Plane + sphere + transformed cube + CSG-diff node, every tangent
    case the reference computes.  ``mirror`` adds a Reflection-shader
    sphere so bounce rounds re-shade bump-mapped surfaces.  ``bump_csg``
    False leaves the CSG node un-bumped — the fused hybrid's FAST-forward
    precondition (pallas_grad._fast_bump_ok)."""
    sc = T.Scene()
    sc.settings.frameWidth, sc.settings.frameHeight = 64, 48
    sc.settings.AAEnabled = False
    sc.settings.maxTraceDepth = 2
    sc.camera = T.Camera(pos=(0, 60, -120), yaw=0, pitch=-15, fov=90)
    sc.camera.set_frame_size(64, 48)
    sc.lights.append(T.PointLight(pos=(60, 180, -60), color=(1, 1, 1), power=40000))
    lam = T.Lambert(name="l", color=(0.7, 0.7, 0.7))
    sc.shaders.append(lam)
    bt = bump_tex_cls(name="bt", scaling=0.05, data=_heightmap())
    if isinstance(bt, T.BumpTexture):
        bt.strength = strength
    sc.textures.append(bt)

    def node(name, geom, transform=None, bumped=True):
        sc.geometries.append(geom)
        n = T.Node(name=name, geometry=geom, shader=lam)
        if transform:
            transform(n.transform)
        if bump and bumped:
            n.bumpmap = bt
        sc.nodes.append(n)

    node("floor", T.Plane(name="p", y=0, limit=200))
    node("ball", T.Sphere(name="s", center=(0, 40, 30), R=30.0))
    node(
        "box",
        T.Cube(name="c", center=(0, 0, 0), side=30.0),
        transform=lambda tr: (tr.scale(1.5, 1.0, 1.0), tr.translate((-60, 20, 10))),
    )
    node(
        "csg",
        T.CsgDiff(
            name="d",
            left=T.Sphere(name="ds", center=(60, 25, 0), R=25.0),
            right=T.Sphere(name="ds2", center=(60, 40, -15), R=20.0),
        ),
        bumped=bump_csg,
    )
    if mirror:
        mir = T.Reflection(name="m", color=(0.9, 0.9, 0.9))
        sc.shaders.append(mir)
        g = T.Sphere(name="ms", center=(-15, 30, -45), R=15.0)
        sc.geometries.append(g)
        sc.nodes.append(T.Node(name="mirror", geometry=g, shader=mir))
    return sc


class TestTangentFrames:
    def test_device_matches_oracle(self, x64):
        """scene_closest(tangents=True) must reproduce the oracle's
        dNdx/dNdy (incl. the cube non-unproject quirk and the node
        transform.direction normalization) on every hit lane."""
        sc = _scene(bump=False)
        packed, static = pack_scene(sc, dtype=jnp.float64)
        rng = np.random.default_rng(7)
        n = 512
        orig = np.array([[0, 80, -150.0]]) + rng.normal(0, 20, (n, 3))
        tgt = rng.normal(0, 60, (n, 3)) + np.array([[0, 20, 0.0]])
        dir = tgt - orig
        dir /= np.linalg.norm(dir, axis=-1, keepdims=True)

        rec = O.HitRecord(n)
        win_o = np.full(n, -1)
        for i, node in enumerate(sc.nodes):
            ok = O.intersect_node(node, orig, dir, rec)
            win_o = np.where(ok, i, win_o)

        hit, win = G.scene_closest(
            packed, static, jnp.asarray(orig), jnp.asarray(dir), tangents=True
        )
        np.testing.assert_array_equal(np.asarray(win), win_o)
        m = win_o >= 0
        assert m.sum() > 100  # non-vacuous
        np.testing.assert_allclose(np.asarray(hit["dndx"])[m], rec.dndx[m], atol=1e-9)
        np.testing.assert_allclose(np.asarray(hit["dndy"])[m], rec.dndy[m], atol=1e-9)

    def test_cube_quirk_preserved(self):
        """X/Z cube faces keep dNdx == (1,0,0) (the reference never
        unprojects the tangents — geometry.d:178-191)."""
        c = jnp.asarray([0.0, 0.0, 0.0])
        orig = jnp.asarray([[-50.0, 0.0, 0.0], [0.0, 0.0, -50.0]])
        dir = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        rec = G.cube_closest(c, jnp.asarray(10.0), orig, dir, tangents=True)
        np.testing.assert_allclose(np.asarray(rec["dndx"]), [[1, 0, 0], [1, 0, 0]])


class TestBumpRender:
    def test_oracle_device_u8_exact(self, x64):
        sc = _scene(bump=True)
        ref = render_scene(sc)
        dev = np.asarray(render_scene_jax(sc, dtype=jnp.float64))
        np.testing.assert_array_equal(srgb_u8(ref), srgb_u8(dev))

    def test_bump_changes_image(self):
        r0 = render_scene(_scene(bump=False))
        r1 = render_scene(_scene(bump=True))
        assert np.abs(r1 - r0).mean() > 1e-3
        assert np.abs(r1).mean() > 1e-3  # not trivially black

    def test_reference_textures_are_noop(self, x64):
        """A plain BitmapTexture in the ``bump`` slot must do NOTHING —
        the reference's modifyNormal base hook is empty (texture.d:10-12)."""
        r0 = render_scene(_scene(bump=False))
        r1 = render_scene(_scene(bump=True, bump_tex_cls=T.BitmapTexture))
        np.testing.assert_array_equal(r0, r1)
        d0 = np.asarray(render_scene_jax(_scene(bump=False), dtype=jnp.float64))
        d1 = np.asarray(
            render_scene_jax(_scene(bump=True, bump_tex_cls=T.BitmapTexture), dtype=jnp.float64)
        )
        np.testing.assert_array_equal(d0, d1)

    def test_f32_device_close(self):
        """The f32 production path stays within a small u8 tail (same
        tolerance family as the lecture-scene parity tests)."""
        sc = _scene(bump=True)
        ref = srgb_u8(render_scene(sc))
        dev = srgb_u8(np.asarray(render_scene_jax(sc, dtype=jnp.float32)))
        diff = np.abs(ref.astype(int) - dev.astype(int))
        # measured u8-exact once the CsgDiff flip probe was widened for f32
        # (ops/geometry.py — 1e-6 is sub-ulp at this coordinate scale);
        # small slack for future texel-boundary fp drift
        assert (diff <= 1).mean() > 0.995, (diff <= 1).mean()

    def test_pallas_dispatch_included(self):
        """Bump scenes dispatch to the fused path via the bump HYBRID
        (ops/pallas_grad.build_bump_round0)."""
        from chess2rt_tpu.ops.pallas_trace import supports

        _, static = pack_scene(_scene(bump=True), dtype=jnp.float32)
        assert static.has_bump and supports(static)
        _, static0 = pack_scene(_scene(bump=False), dtype=jnp.float32)
        assert not static0.has_bump and supports(static0)


@pytest.mark.slow  # interpret-mode fused kernels: heavy by design
class TestBumpFused:
    """The bump HYBRID on the fused path: the kernel pins (win, vis, t,
    N) in registers, a differentiable XLA reshade
    with tangent-carrying leaf-pinned records applies the perturbation
    (ops/pallas_grad.build_bump_round0).  Interpret-mode Pallas on CPU."""

    def _pair(self, mirror=False, bump_csg=True):
        packed, static = pack_scene(
            _scene(bump=True, mirror=mirror, bump_csg=bump_csg), dtype=jnp.float32
        )
        st_xla = dataclasses.replace(static, use_pallas=False)
        st_fus = dataclasses.replace(static, use_pallas=True, interpret_pallas=True)
        return packed, st_xla, st_fus

    @pytest.mark.parametrize("bump_csg", [True, False])
    def test_fused_matches_xla(self, bump_csg):
        """bump_csg=True exercises the differentiable-reshade forward
        (bump-mapped CSG gate), False the FAST kernel-record forward
        (reconstruct_tangents, custom VJP)."""
        from chess2rt_tpu.ops.pallas_grad import _fast_bump_ok

        packed, st_xla, st_fus = self._pair(bump_csg=bump_csg)
        assert _fast_bump_ok(st_fus) == (not bump_csg)
        key = jax.random.PRNGKey(0)
        img_x = jax.jit(lambda p, k: render_frame(p, st_xla, k))(packed, key)
        img_f = jax.jit(lambda p, k: render_frame(p, st_fus, k))(packed, key)
        # the fast forward shades from the KERNEL's own t (like the
        # non-bump fused path), one fp class looser than the XLA-t reshade
        atol = 2e-5 if bump_csg else 1e-4
        np.testing.assert_allclose(np.asarray(img_f), np.asarray(img_x), atol=atol)

    def test_fused_matches_xla_with_bounces(self):
        """Mirror sphere: bounce rounds re-enter the hybrid (ray-input
        form) and re-shade bump-mapped surfaces in the reflection."""
        packed, st_xla, st_fus = self._pair(mirror=True)
        key = jax.random.PRNGKey(0)
        img_x = np.asarray(jax.jit(lambda p, k: render_frame(p, st_xla, k))(packed, key))
        img_f = np.asarray(jax.jit(lambda p, k: render_frame(p, st_fus, k))(packed, key))
        # knife-edge tolerance: the mirror's curved reflection of bump
        # knife edges may pin a different texel on isolated lanes
        close = np.isclose(img_f, img_x, atol=2e-5)
        assert close.mean() > 0.999, close.mean()

    def test_adaptive_aa_composes_with_bump(self):
        """adaptiveAA's lane-compacted taps re-enter the hybrid at flagged
        -pixel width — the fused adaptive path must match the XLA adaptive
        path on a bump scene."""
        sc = _scene(bump=True)
        sc.settings.AAEnabled = True
        packed, static = pack_scene(sc, dtype=jnp.float32)
        st_xla = dataclasses.replace(static, use_pallas=False, aa_adaptive=True)
        st_fus = dataclasses.replace(
            static, use_pallas=True, interpret_pallas=True, aa_adaptive=True
        )
        key = jax.random.PRNGKey(0)
        img_x = np.asarray(jax.jit(lambda p, k: render_frame(p, st_xla, k))(packed, key))
        img_f = np.asarray(jax.jit(lambda p, k: render_frame(p, st_fus, k))(packed, key))
        close = np.isclose(img_f, img_x, atol=2e-5)
        assert close.mean() > 0.999, close.mean()
        # the mask must actually bite vs the non-AA base
        st_base = dataclasses.replace(st_fus, aa_enabled=False)
        base = np.asarray(jax.jit(lambda p, k: render_frame(p, st_base, k))(packed, key))
        assert (img_f != base).any()

    @pytest.mark.parametrize("bump_csg", [True, False])
    def test_fused_grads_match_xla(self, bump_csg):
        packed, st_xla, st_fus = self._pair(bump_csg=bump_csg)
        key = jax.random.PRNGKey(0)
        tgt = jax.jit(lambda p, k: render_frame(p, st_xla, k))(packed, key) * 0.9

        def loss(st):
            return lambda p: ((render_frame(p, st, key) - tgt) ** 2).mean()

        gx = jax.jit(jax.grad(loss(st_xla)))(packed)
        gf = jax.jit(jax.grad(loss(st_fus)))(packed)
        for name in ("sphere_center", "sphere_r", "cube_center", "node_matrix",
                     "light_pos", "mat_color", "plane_y", "camera"):
            vx, vf = getattr(gx, name), getattr(gf, name)
            if name == "camera":
                vx, vf = vx.pos, vf.pos
            vx, vf = np.asarray(vx), np.asarray(vf)
            assert np.isfinite(vf).all(), name
            scale = max(np.abs(vx).max(), np.abs(vf).max(), 1e-12)
            # fast-forward primals differ from XLA at kernel-t fp, so the
            # (image - target) residual feeding the VJP does too
            tol = (5e-4 if bump_csg else 2e-3) * scale
            np.testing.assert_allclose(vf, vx, atol=tol, err_msg=name)


class TestBumpGrads:
    def test_grads_finite_through_bump(self):
        """Inverse rendering through a bump-mapped scene: gradients stay
        finite and flow to geometry/material leaves (the bump atlas itself
        is non-trainable by design)."""
        packed, static = pack_scene(_scene(bump=True), dtype=jnp.float32)
        from chess2rt_tpu.render.pipeline import render_frame

        def loss(p):
            return (render_frame(p, static, jax.random.PRNGKey(0)) ** 2).mean()

        g = jax.grad(loss)(packed)
        for name in ("sphere_center", "mat_color", "light_pos", "plane_y"):
            v = np.asarray(getattr(g, name))
            assert np.isfinite(v).all(), name
        assert abs(np.asarray(g.sphere_center)).sum() > 0
