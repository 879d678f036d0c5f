"""Pallas fused primary-pass kernel vs the XLA pipeline (interpret mode on
CPU; the compiled path is exercised on the GPU by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chess2rt_tpu.models import types as T
from chess2rt_tpu.models.packed import pack_scene
from chess2rt_tpu.ops.pallas_trace import build_primary_kernel, supports
from chess2rt_tpu.render.pipeline import render_frame
from chess2rt_tpu.scene.loader import parse_scene_from_file


def _scene(data_dir, w=48, h=32):
    sc = parse_scene_from_file(str(data_dir / "lecture4.sdl"))
    sc.settings.frameWidth, sc.settings.frameHeight = w, h
    sc.camera.set_frame_size(w, h)
    sc.settings.AAEnabled = False
    return sc


class TestSupports:
    def test_lecture4_supported(self, data_dir):
        _, static = pack_scene(_scene(data_dir))
        assert supports(static)

    def test_lecture5_supported(self, data_dir):
        """Round 2: CSG + bitmap textures + transforms are in-kernel now."""
        sc = parse_scene_from_file(str(data_dir / "lecture5.sdl"))
        _, static = pack_scene(sc)
        assert supports(static)

    def test_dof_supported_gi_falls_back(self, data_dir):
        sc = _scene(data_dir)
        sc.camera.dof = True
        _, static = pack_scene(sc)
        assert supports(static)  # DoF rides the ray-input kernel (round 2)
        sc.camera.dof = False
        sc.settings.GIEnabled = True
        _, static = pack_scene(sc)
        assert not supports(static)  # GI needs BRDF sampling -> XLA


class TestKernelParity:
    def test_lecture4_checker(self, data_dir):
        sc = _scene(data_dir)
        packed, static = pack_scene(sc, dtype=jnp.float32)
        fn = build_primary_kernel(static, static.width, static.height, interpret=True)
        out = np.asarray(fn(packed)).reshape(static.height, static.width, 3)
        ref = np.asarray(render_frame(packed, static, jax.random.PRNGKey(0)))
        np.testing.assert_allclose(out, ref, atol=5e-4)

    def test_mixed_scene_phong_sphere_cube(self, data_dir):
        sc = _scene(data_dir, w=64, h=48)
        ph = T.Phong(name="ph", color=(0.2, 0.3, 0.8), exponent=30.0, strength=0.7)
        sc.shaders.append(ph)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="b", center=(-40, 40, 200), R=35.0), shader=ph)
        )
        box = T.Node(name="box", geometry=T.Cube(name="c", center=(0, 0, 0), side=50.0), shader=sc.shaders[0])
        box.transform.translate((60, 27, 250))
        sc.nodes.append(box)
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert supports(static)
        fn = build_primary_kernel(static, static.width, static.height, interpret=True)
        out = np.asarray(fn(packed)).reshape(static.height, static.width, 3)
        ref = np.asarray(render_frame(packed, static, jax.random.PRNGKey(0)))
        np.testing.assert_allclose(out, ref, atol=5e-4)

    def test_lecture5_flagship(self, data_dir):
        """The flagship scene end-to-end: CSG interval engine, full matrix
        transform, deferred bitmap texturing (plane + textured sphere with
        polynomial atan2/asin UVs), Phong — all through the fused kernel,
        vs the XLA anchor.  A small knife-edge tail is allowed: in-kernel
        atan2 differs from XLA's by ~1 ulp, which can flip a texel at a
        boundary."""
        import dataclasses

        sc = parse_scene_from_file(str(data_dir / "lecture5.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 64, 48
        sc.camera.set_frame_size(64, 48)
        sc.settings.AAEnabled = False
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert supports(static)
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        st = dataclasses.replace(static, aa_enabled=False)
        out = np.asarray(build_flagship_renderer(st, 64, 48, interpret=True)(packed))
        ref = np.asarray(render_frame(packed, st, jax.random.PRNGKey(0)))
        d = np.abs(out - ref).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())
        assert np.median(d) < 2e-4

    def test_reflection_bounces(self, data_dir):
        """Mirror sphere: kernel round 0 + XLA compacted bounce rounds must
        match the all-XLA wavefront."""
        import dataclasses

        sc = _scene(data_dir, w=64, h=48)
        m = T.Reflection(name="m", color=(0.9, 0.9, 0.9))
        sc.shaders.append(m)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="b", center=(0, 60, 120), R=40.0), shader=m)
        )
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert supports(static)
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        st = dataclasses.replace(static, aa_enabled=False, bounce_capacity=1024)
        out = np.asarray(build_flagship_renderer(st, 64, 48, interpret=True)(packed))
        ref = np.asarray(render_frame(packed, st, jax.random.PRNGKey(0)))
        d = np.abs(out - ref).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())

    def test_fullwidth_bounce_mode_bitexact(self, data_dir):
        """bounce_mode="full" (bounce rounds at frame width, no compaction)
        must be bit-identical to the compacted mode — same kernel, same
        combine, only the lane layout differs."""
        import dataclasses

        sc = _scene(data_dir, w=64, h=48)
        m = T.Reflection(name="m", color=(0.9, 0.9, 0.9))
        sc.shaders.append(m)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="b", center=(0, 60, 120), R=40.0), shader=m)
        )
        packed, static = pack_scene(sc, dtype=jnp.float32)
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        st_c = dataclasses.replace(
            static, aa_enabled=False, bounce_capacity=1024, bounce_mode="compact"
        )
        st_f = dataclasses.replace(st_c, bounce_mode="full")
        out_c = np.asarray(build_flagship_renderer(st_c, 64, 48, interpret=True)(packed))
        out_f = np.asarray(build_flagship_renderer(st_f, 64, 48, interpret=True)(packed))
        np.testing.assert_array_equal(out_c, out_f)

    def test_block_bounce_mode_bitexact(self, data_dir):
        """bounce_mode="block" (128-lane-block-granular compaction) must be
        bit-identical to the full-width mode — same kernel, same combine,
        only which lanes sit in which buffer slots differs.  Covers both
        the compacted path and the capacity-overflow lax.cond fallback."""
        import dataclasses

        sc = _scene(data_dir, w=64, h=48)
        m = T.Reflection(name="m", color=(0.9, 0.9, 0.9))
        sc.shaders.append(m)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="b", center=(0, 60, 120), R=40.0), shader=m)
        )
        packed, static = pack_scene(sc, dtype=jnp.float32)
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        st_f = dataclasses.replace(
            static, aa_enabled=False, bounce_capacity=1024, bounce_mode="full"
        )
        st_b = dataclasses.replace(st_f, bounce_mode="block", bounce_block_capacity=16)
        # capacity 1 block (rounded up to one kernel tile = 8) overflows ->
        # the lax.cond full-width fallback must carry the frame
        st_o = dataclasses.replace(st_f, bounce_mode="block", bounce_block_capacity=1)
        out_f = np.asarray(build_flagship_renderer(st_f, 64, 48, interpret=True)(packed))
        out_b = np.asarray(build_flagship_renderer(st_b, 64, 48, interpret=True)(packed))
        np.testing.assert_array_equal(out_f, out_b)
        out_o = np.asarray(build_flagship_renderer(st_o, 64, 48, interpret=True)(packed))
        # the overflow fallback is now the full-width KERNEL rounds (round
        # 4: the XLA-scan fallback's stacked AD residuals OOM'd the 1080p
        # grad step) — same kernel, same combine => bit-identical
        np.testing.assert_array_equal(out_o, out_f)

    def test_texel_tap_reuse_bitexact(self, data_dir):
        """AA-tap texel-gather reuse (round-4, VERDICT r3 item 4): taps
        1..4 reuse the base tap's gathered quads and re-gather only
        changed-key lanes.  Same keys -> same rows, so the quirk-AA frame
        must be BIT-identical with reuse on, off, and through the
        overflow (tiny capacity) lax.cond fallback."""
        import dataclasses

        sc = parse_scene_from_file(str(data_dir / "lecture5.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 64, 48
        sc.camera.set_frame_size(64, 48)
        m = T.Reflection(name="m", color=(0.9, 0.85, 0.8))
        sc.shaders.append(m)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="bm", center=(40, 30, 160), R=25.0), shader=m)
        )
        packed, static = pack_scene(sc, dtype=jnp.float32)
        st_on = dataclasses.replace(
            static, use_pallas=True, interpret_pallas=True, texel_tap_reuse=True
        )
        st_off = dataclasses.replace(st_on, texel_tap_reuse=False)
        st_tiny = dataclasses.replace(st_on, texel_reuse_capacity=8)
        key = jax.random.PRNGKey(0)
        a = np.asarray(jax.jit(lambda p: render_frame(p, st_on, key))(packed))
        b = np.asarray(jax.jit(lambda p: render_frame(p, st_off, key))(packed))
        c = np.asarray(jax.jit(lambda p: render_frame(p, st_tiny, key))(packed))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)

    @pytest.mark.parametrize("chunk", [1024, 2048])
    def test_chunked_fused_matches_unchunked(self, data_dir, chunk):
        """chunk_pixels through the FUSED path (memory-bounded slabs via
        lax.map + the ray-input kernel) must match the whole-frame fused
        render; rays come from XLA screen_rays instead of in-kernel raygen,
        so the usual kernel/XLA fp tolerance applies.  chunk=1024 divides
        the 3072-pixel frame exactly; chunk=2048 pads to 2 slabs of 2048
        (n_pad=4096 > n), exercising the pad-lane clamp, the [:n] slice,
        and the zero-cotangent guarantee on the duplicated last pixel."""
        import dataclasses

        sc = _scene(data_dir, w=64, h=48)
        m = T.Reflection(name="m", color=(0.9, 0.9, 0.9))
        sc.shaders.append(m)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="b", center=(0, 60, 120), R=40.0), shader=m)
        )
        packed, static = pack_scene(sc, dtype=jnp.float32)
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        st = dataclasses.replace(static, aa_enabled=False)
        st_c = dataclasses.replace(st, chunk_pixels=chunk)
        out = np.asarray(build_flagship_renderer(st, 64, 48, interpret=True)(packed))
        out_c = np.asarray(build_flagship_renderer(st_c, 64, 48, interpret=True)(packed))
        d = np.abs(out - out_c).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())
        assert np.median(d) < 2e-4

        # the chunked path (lax.map slabs) must stay differentiable with
        # gradients matching the whole-frame fused VJP
        def loss(st):
            r = build_flagship_renderer(st, 64, 48, interpret=True)
            return lambda p: (r(p) ** 2).mean()

        g = jax.grad(loss(st))(packed)
        g_c = jax.grad(loss(st_c))(packed)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_c)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-6)

    def test_aa_taps_match_xla(self, data_dir):
        """5-tap AA through the flagship renderer == the XLA AA pipeline."""
        sc = _scene(data_dir, w=32, h=24)
        sc.settings.AAEnabled = True
        packed, static = pack_scene(sc, dtype=jnp.float32)
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        out = np.asarray(build_flagship_renderer(static, 32, 24, interpret=True)(packed))
        ref = np.asarray(render_frame(packed, static, jax.random.PRNGKey(0)))
        d = np.abs(out - ref).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())

    def test_adaptive_aa_fused_matches_xla(self, data_dir):
        """adaptiveAA through the fused flagship renderer: the LANE-
        compacted fast path (flagged pixels -> ray-input kernel at cap_aa
        width; tap rays are arithmetic in the pixel index) and the
        forced-overflow full-width fallback must both match the XLA
        adaptive pipeline; gradients through the compact path (gather ->
        taps -> scatter-set) must match the XLA adaptive VJP."""
        import dataclasses

        sc = _scene(data_dir, w=64, h=48)
        sc.settings.AAEnabled = True
        sc.settings.adaptiveAA = True
        m = T.Reflection(name="m", color=(0.9, 0.9, 0.9))
        sc.shaders.append(m)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="b", center=(0, 60, 120), R=40.0), shader=m)
        )
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert static.aa_adaptive
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        ref = np.asarray(render_frame(packed, static, jax.random.PRNGKey(0)))
        out = np.asarray(build_flagship_renderer(static, 64, 48, interpret=True)(packed))
        d = np.abs(out - ref).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())
        # overflow: a fine checker flags >1894 of 3072 pixels, above the
        # minimum (one-tile) capacity -> the lax.cond full-width fallback
        sc_o = _scene(data_dir, w=64, h=48)
        sc_o.settings.AAEnabled = True
        sc_o.settings.adaptiveAA = True
        for t in sc_o.textures:
            if hasattr(t, "size"):
                t.size = 1.0
        packed_o, st_o = pack_scene(sc_o, dtype=jnp.float32)
        st_o = dataclasses.replace(st_o, aa_capacity=1)  # rounds up to 1 tile
        ref_o = np.asarray(render_frame(packed_o, st_o, jax.random.PRNGKey(0)))
        out_o = np.asarray(build_flagship_renderer(st_o, 64, 48, interpret=True)(packed_o))
        d_o = np.abs(out_o - ref_o).max(-1)
        assert (d_o > 2e-3).sum() <= 3, ((d_o > 2e-3).sum(), d_o.max())

        def loss(st):
            r = build_flagship_renderer(st, 64, 48, interpret=True)
            return lambda p: (r(p) ** 2).mean()

        g_ref = jax.grad(lambda p: (render_frame(p, static, jax.random.PRNGKey(0)) ** 2).mean())(packed)
        g = jax.grad(loss(static))(packed)
        for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g)):
            a, b = np.asarray(a), np.asarray(b)
            if a.size == 0:
                continue
            assert np.isfinite(b).all()
            np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-5)

    def test_adaptive_aa_dof_and_gi_fused(self, data_dir):
        """adaptiveAA in the MC (DoF) and GI fused renderers.  The DoF
        fast path LANE-compacts the 4 AA taps (each a full dof_samples MC
        loop) and must reproduce the XLA pipeline's full-width values
        exactly — the compacted loop draws (n,)-shaped threefry uniforms
        and gathers them, because threefry is positional and a [cap]-shaped
        draw would be a different stream.  A near-pinhole lecture4 DoF
        config flags 1882/3072 pixels: above the one-tile minimum capacity
        (exercising the overflow full-width fallback at the default cap)
        and below aa_capacity=2048 (exercising the compact path)."""
        import dataclasses

        sc = _scene(data_dir, w=64, h=48)
        sc.settings.AAEnabled = True
        sc.settings.adaptiveAA = True
        sc.camera.dof = True
        sc.camera.numSamples = 2
        sc.camera.fNumber = 500.0
        sc.camera.discMultiplier = 10.0 / 500.0
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert static.dof and static.aa_adaptive
        from chess2rt_tpu.render.pipeline import aa_detect
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer, build_gi_renderer

        key = jax.random.PRNGKey(5)
        base = np.asarray(
            render_frame(packed, dataclasses.replace(static, aa_enabled=False), key)
        )
        flagged = int(np.asarray(aa_detect(jnp.asarray(base))).sum())
        assert 1024 < flagged <= 2048, flagged  # the premise of both cases
        ref = np.asarray(render_frame(packed, static, key))
        # compact path: cap 2048 >= flagged
        st_c = dataclasses.replace(static, aa_capacity=2048)
        out = np.asarray(build_flagship_renderer(st_c, 64, 48, interpret=True)(packed, key))
        d = np.abs(out - ref).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())
        # overflow: default cap rounds to one tile (1024) < flagged ->
        # the lax.cond full-width fallback must carry the frame
        out_o = np.asarray(build_flagship_renderer(static, 64, 48, interpret=True)(packed, key))
        d_o = np.abs(out_o - ref).max(-1)
        assert (d_o > 2e-3).sum() <= 3, ((d_o > 2e-3).sum(), d_o.max())

        sc2 = _scene(data_dir, w=16, h=12)
        sc2.settings.AAEnabled = True
        sc2.settings.adaptiveAA = True
        sc2.settings.GIEnabled = True
        sc2.settings.pathsPerPixel = 4
        packed2, st2 = pack_scene(sc2, dtype=jnp.float32)
        st2 = dataclasses.replace(st2, gi_point_light_direct=True)
        ref2 = np.asarray(render_frame(packed2, st2, key))
        out2 = np.asarray(build_gi_renderer(st2, 16, 12, interpret=True)(packed2, key))
        d2 = np.abs(out2 - ref2).max(-1)
        assert (d2 > 2e-3).sum() <= 3, ((d2 > 2e-3).sum(), d2.max())

    def test_proc2_texture(self, data_dir):
        sc = parse_scene_from_file(str(data_dir / "lecture4-proc-texture.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 48, 32
        sc.camera.set_frame_size(48, 32)
        sc.settings.AAEnabled = False
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert supports(static)
        fn = build_primary_kernel(static, static.width, static.height, interpret=True)
        out = np.asarray(fn(packed)).reshape(static.height, static.width, 3)
        ref = np.asarray(render_frame(packed, static, jax.random.PRNGKey(0)))
        np.testing.assert_allclose(out, ref, atol=5e-4)


class TestMonteCarloModes:
    def test_dof_matches_xla_same_keys(self, data_dir):
        """DoF through the ray-input kernel uses the SAME jax.random stream
        as the XLA pipeline — identical rays, so the outputs match to
        kernel-vs-XLA fp (plus knife edges)."""
        import dataclasses

        sc = parse_scene_from_file(str(data_dir / "zaphod.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 32, 22
        sc.camera.set_frame_size(32, 22)
        sc.settings.AAEnabled = False
        sc.camera.numSamples = 4
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert static.dof
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer, supports

        assert supports(static)
        st = dataclasses.replace(static, aa_enabled=False)
        key = jax.random.PRNGKey(7)
        out = np.asarray(build_flagship_renderer(st, 32, 22, interpret=True)(packed, key))
        ref = np.asarray(render_frame(packed, st, key))
        d = np.abs(out - ref).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())

    def test_chunked_dof_matches_unchunked(self, data_dir):
        """chunk_pixels in the MC (DoF/stereo) fused path: each MC pass
        lax.maps the ray batch through a slab-width ray-input kernel +
        bounce finisher; the RNG stream is generated frame-wide BEFORE
        slabbing, so the result must reproduce the whole-frame MC render
        (2048-pixel chunks on a 3072-pixel frame: 2 slabs, 1024 pad
        lanes re-tracing the last ray and sliced off)."""
        import dataclasses

        sc = parse_scene_from_file(str(data_dir / "zaphod.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 64, 48
        sc.camera.set_frame_size(64, 48)
        sc.settings.AAEnabled = False
        sc.camera.numSamples = 2
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert static.dof
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer, supports

        assert supports(static)
        st = dataclasses.replace(static, aa_enabled=False)
        st_c = dataclasses.replace(st, chunk_pixels=2048)
        key = jax.random.PRNGKey(11)
        out = np.asarray(build_flagship_renderer(st, 64, 48, interpret=True)(packed, key))
        out_c = np.asarray(build_flagship_renderer(st_c, 64, 48, interpret=True)(packed, key))
        d = np.abs(out - out_c).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())
        assert np.median(d) < 2e-4

    def test_stereo_matches_xla(self, data_dir):
        import dataclasses

        sc = _scene(data_dir, w=32, h=24)
        sc.camera.stereoSeparation = 2.0
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert static.stereo
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer, supports

        assert supports(static)
        st = dataclasses.replace(static, aa_enabled=False)
        key = jax.random.PRNGKey(3)
        out = np.asarray(build_flagship_renderer(st, 32, 24, interpret=True)(packed, key))
        ref = np.asarray(render_frame(packed, st, key))
        d = np.abs(out - ref).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())

    def test_gi_matches_xla_same_keys(self, data_dir):
        """GI through the want_hit kernel: same jax.random stream as
        trace_path, so contributing bounces match the XLA path tightly
        (NEE extension on so the image is non-black)."""
        import dataclasses

        sc = _scene(data_dir, w=24, h=16)
        sc.settings.GIEnabled = True
        sc.settings.pathsPerPixel = 6
        sc.nodes.append(
            T.Node(name="wall", geometry=T.Sphere(name="w", center=(60, 80, 330), R=50.0),
                   shader=T.Lambert(name="white", color=(0.8, 0.8, 0.8)))
        )
        sc.geometries.append(sc.nodes[-1].geometry)
        sc.shaders.append(sc.nodes[-1].shader)
        packed, static = pack_scene(sc, dtype=jnp.float32)
        from chess2rt_tpu.ops.pallas_trace import build_gi_renderer, supports_gi

        st = dataclasses.replace(static, gi_point_light_direct=True)
        assert supports_gi(st)
        key = jax.random.PRNGKey(5)
        out = np.asarray(build_gi_renderer(st, 24, 16, interpret=True)(packed, key))
        ref = np.asarray(render_frame(packed, st, key))
        assert out.max() > 0.01
        d = np.abs(out - ref).max(-1)
        assert (d > 5e-3).mean() < 0.02, ((d > 5e-3).mean(), d.max())

    def test_gi_quirk_path_black(self, data_dir):
        """Reference-semantics GI (solidAngle == 0): exactly black through
        the kernel path too."""
        import dataclasses

        sc = _scene(data_dir, w=16, h=12)
        sc.settings.GIEnabled = True
        sc.settings.pathsPerPixel = 2
        packed, static = pack_scene(sc, dtype=jnp.float32)
        from chess2rt_tpu.ops.pallas_trace import build_gi_renderer, supports_gi

        assert supports_gi(static)
        out = np.asarray(build_gi_renderer(static, 16, 12, interpret=True)(packed, jax.random.PRNGKey(0)))
        np.testing.assert_array_equal(out, 0.0)


class TestRefraction:
    def test_refraction_matches_xla(self, data_dir):
        """Glass sphere (framework-extension Refraction shader): in-kernel
        single-sided refraction + TIR fallback vs the XLA wavefront."""
        import dataclasses

        sc = _scene(data_dir, w=48, h=36)
        g = T.Refraction(name="glass", color=(0.95, 0.95, 0.95), ior=1.5)
        sc.shaders.append(g)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="b", center=(0, 50, 150), R=35.0), shader=g)
        )
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert supports(static)
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        st = dataclasses.replace(static, aa_enabled=False, bounce_capacity=1024)
        out = np.asarray(build_flagship_renderer(st, 48, 36, interpret=True)(packed))
        ref = np.asarray(render_frame(packed, st, jax.random.PRNGKey(0)))
        assert np.isfinite(out).all()
        d = np.abs(out - ref).max(-1)
        # refraction bends knife edges hard; allow a slightly wider tail
        assert (d > 2e-3).mean() < 0.01, ((d > 2e-3).mean(), d.max())


class TestMergedEnvBitmapGather:
    """combine_outputs merges the deferred bitmap-texel gather and the
    miss-ray cubemap gather into ONE per-ray row gather when a scene has
    both (pallas_trace.combine_outputs: one index per ray instead of two)."""

    def _scene(self, data_dir):
        sc = parse_scene_from_file(str(data_dir / "zaphod.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 32, 22
        sc.camera.set_frame_size(32, 22)
        sc.settings.AAEnabled = False
        sc.camera.numSamples = 3
        # pitch the camera toward the horizon: zaphod's book sits on an
        # infinite plane and the stock -41.8 pitch makes EVERY ray hit it —
        # the merged gather needs both texel hits AND env misses in-frame
        sc.camera.pitch = -8.0
        # gradient cubemap so env pixels vary (merged-key mistakes show up)
        cm = np.linspace(0.1, 0.9, 6 * 8 * 8 * 3, dtype=np.float32).reshape(6, 8, 8, 3)
        sc.environment.cubemap = cm
        return sc

    def test_matches_xla(self, data_dir):
        import dataclasses

        sc = self._scene(data_dir)
        packed, static = pack_scene(sc, dtype=jnp.float32)
        assert static.has_env and static.dof
        from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer

        st = dataclasses.replace(static, aa_enabled=False)
        key = jax.random.PRNGKey(3)
        out = np.asarray(build_flagship_renderer(st, 32, 22, interpret=True)(packed, key))
        ref = np.asarray(render_frame(packed, st, key))
        assert np.isfinite(out).all()
        d = np.abs(out - ref).max(-1)
        assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())

    def test_merged_gather_grads_flow(self, data_dir):
        """The merged gather's texel VJP gives finite, non-zero atlas AND
        cubemap gradients through the fused path."""
        import dataclasses

        sc = self._scene(data_dir)
        packed, static = pack_scene(sc, dtype=jnp.float32)
        st = dataclasses.replace(
            static, use_pallas=True, interpret_pallas=True, train_textures=True
        )
        key = jax.random.PRNGKey(5)

        def loss(p):
            img = render_frame(p, st, key)
            return (img * jnp.cos(jnp.arange(img.size).reshape(img.shape))).sum()

        g = jax.grad(loss)(packed)
        for name in ("bitmap_atlas", "env_cubemap"):
            a = np.asarray(getattr(g, name))
            assert np.isfinite(a).all(), name
            assert np.abs(a).sum() > 0, name
