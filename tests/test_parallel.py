"""Multi-device tests on the 8-way virtual CPU mesh (conftest.py sets
xla_force_host_platform_device_count=8 — the standard 'multi-node without a
cluster' trick, SURVEY.md §4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chess2rt_tpu.models.packed import pack_scene
from chess2rt_tpu.parallel import (
    make_mesh,
    make_sharded_render_fn,
    make_sharded_value_and_grad,
)
from chess2rt_tpu.render.pipeline import render_frame, render_scene_jax
from chess2rt_tpu.scene.loader import parse_scene_from_file


@pytest.fixture(scope="module")
def scene(data_dir):
    sc = parse_scene_from_file(str(data_dir / "lecture4.sdl"))
    # 50x30 = 1500 px: deliberately NOT divisible by 8 to exercise padding
    sc.settings.frameWidth, sc.settings.frameHeight = 50, 30
    sc.camera.set_frame_size(50, 30)
    return sc


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh()


class TestShardedRender:
    def test_bit_identical_to_single_chip(self, scene, mesh):
        packed, static = pack_scene(scene, dtype=jnp.float32)
        fn = make_sharded_render_fn(static, mesh)
        img = np.asarray(fn(packed, jax.random.PRNGKey(0)))
        ref = np.asarray(render_scene_jax(scene, dtype=jnp.float32))
        np.testing.assert_array_equal(img, ref)

    def test_output_sharding_is_row_partitioned(self, scene, mesh):
        packed, static = pack_scene(scene, dtype=jnp.float32)
        fn = make_sharded_render_fn(static, mesh)
        out = fn(packed, jax.random.PRNGKey(0))
        assert out.shape == (30, 50, 3)
        assert np.isfinite(np.asarray(out)).all()

    def test_adaptive_aa_bit_identical_to_single_chip(self, scene, mesh):
        """adaptiveAA sharded: base pass sharded, needs-AA detect on the
        GLOBAL frame (halo comms by the partitioner), taps sharded with
        mask select — deterministic scenes must match single-chip bitwise."""
        packed, static = pack_scene(scene, dtype=jnp.float32)
        st = dataclasses.replace(static, aa_enabled=True, aa_adaptive=True)
        fn = make_sharded_render_fn(st, mesh)
        img = np.asarray(fn(packed, jax.random.PRNGKey(0)))
        # jit the single-chip reference: eager CPU execution rounds
        # differently (no fusion/FMA), so eager-vs-jitted is NOT bitwise
        ref = np.asarray(
            jax.jit(lambda p, k: render_frame(p, st, k))(packed, jax.random.PRNGKey(0))
        )
        np.testing.assert_array_equal(img, ref)
        # and the mask must actually bite: adaptive != quirk somewhere
        stq = dataclasses.replace(st, aa_adaptive=False)
        quirk = np.asarray(
            jax.jit(lambda p, k: render_frame(p, stq, k))(packed, jax.random.PRNGKey(0))
        )
        assert (img != quirk).any()

    def test_mesh_subset(self, scene):
        # a 2-device mesh must give the same frame as the 8-device one
        packed, static = pack_scene(scene, dtype=jnp.float32)
        m2 = make_mesh(jax.devices()[:2])
        img2 = np.asarray(make_sharded_render_fn(static, m2)(packed, jax.random.PRNGKey(0)))
        ref = np.asarray(render_scene_jax(scene, dtype=jnp.float32))
        np.testing.assert_array_equal(img2, ref)


class TestShardedGrad:
    def test_loss_and_grads_match_single_device(self, scene, mesh):
        packed, static = pack_scene(scene, dtype=jnp.float32)
        vg = make_sharded_value_and_grad(static, mesh)
        target = jnp.zeros((30, 50, 3))
        key = jax.random.PRNGKey(0)
        loss, g = vg(packed, target, key)

        def loss1(p):
            return ((render_frame(p, static, key) - target) ** 2).mean()

        l1, g1 = jax.value_and_grad(loss1)(packed)
        np.testing.assert_allclose(float(loss), float(l1), rtol=1e-6)
        for f in ("light_power", "plane_y", "checker_c2", "mat_color"):
            np.testing.assert_allclose(
                np.asarray(getattr(g, f)), np.asarray(getattr(g1, f)), rtol=1e-5, atol=1e-12
            )
        np.testing.assert_allclose(float(g.camera.fov), float(g1.camera.fov), rtol=1e-5)

    def test_adaptive_aa_grads_match_single_device(self, scene, mesh):
        """adaptiveAA inverse rendering sharded: the stop-gradient mask
        comes from a sharded forward base pass; loss + grads must match
        the single-device adaptive VJP."""
        packed, static = pack_scene(scene, dtype=jnp.float32)
        st = dataclasses.replace(static, aa_enabled=True, aa_adaptive=True)
        vg = make_sharded_value_and_grad(st, mesh)
        target = jnp.zeros((30, 50, 3))
        key = jax.random.PRNGKey(0)
        loss, g = vg(packed, target, key)
        l1, g1 = jax.value_and_grad(
            lambda p: ((render_frame(p, st, key) - target) ** 2).mean()
        )(packed)
        np.testing.assert_allclose(float(loss), float(l1), rtol=1e-6)
        for f in ("light_power", "plane_y", "checker_c2", "mat_color"):
            np.testing.assert_allclose(
                np.asarray(getattr(g, f)), np.asarray(getattr(g1, f)), rtol=1e-5, atol=1e-12
            )

    def test_grad_descent_step_reduces_loss(self, scene, mesh):
        """One SGD step on the light power against a dimmer target frame
        must reduce the loss — the minimal end-to-end inverse-rendering
        smoke test over the mesh."""
        packed, static = pack_scene(scene, dtype=jnp.float32)
        key = jax.random.PRNGKey(0)
        dim = dataclasses.replace(packed, light_power=packed.light_power * 0.5)
        target = render_frame(dim, static, key)
        vg = make_sharded_value_and_grad(static, mesh)
        l0, g = vg(packed, target, key)
        stepped = dataclasses.replace(
            packed, light_power=packed.light_power - 2e8 * g.light_power
        )
        l1, _ = vg(stepped, target, key)
        assert float(l1) < float(l0)


class TestShardedFused:
    """The FUSED Pallas flagship renderer under the mesh (round-3 VERDICT
    item 1): each shard ray-gens in-kernel from its lin base and runs the
    full fused pipeline (round-0 kernel + deferred texel combine + block-
    compacted bounce rounds) on its pixel slice.  Per-lane kernel math is
    bit-identical to the single-chip fused path; the residual deltas below
    are XLA fusion/FMA differences in the (per-ray) XLA combine at
    different widths — pinned at the ~1-ulp level plus a u8-after-sRGB
    gate, the project's pixel-exactness currency."""

    @pytest.fixture(scope="class")
    def fused(self, data_dir):
        from chess2rt_tpu.models import types as T

        sc = parse_scene_from_file(str(data_dir / "lecture5.sdl"))
        w, h = 48, 32  # 1536 px: pads to 2048 on the 8-way mesh (C=256)
        sc.settings.frameWidth, sc.settings.frameHeight = w, h
        sc.camera.set_frame_size(w, h)
        # mirror sphere so the block-compacted bounce rounds run per shard
        m = T.Reflection(name="m", color=(0.9, 0.85, 0.8))
        sc.shaders.append(m)
        sc.nodes.append(
            T.Node(name="ball", geometry=T.Sphere(name="bm", center=(40, 30, 160), R=25.0), shader=m)
        )
        packed, static = pack_scene(sc, dtype=jnp.float32)
        static = dataclasses.replace(static, use_pallas=True, interpret_pallas=True)
        return packed, static

    @staticmethod
    def _assert_frames_match(img, ref, atol=2e-5):
        """~1-ulp float agreement + u8-after-sRGB pixel-exactness gate."""
        from chess2rt_tpu.utils.color import srgb_u8

        assert np.abs(img - ref).max() <= atol, np.abs(img - ref).max()
        a = srgb_u8(img).astype(int)
        b = srgb_u8(ref).astype(int)
        assert np.abs(a - b).max() <= 1
        assert (a == b).mean() >= 0.999

    @pytest.mark.slow
    def test_matches_single_chip_fused(self, fused, mesh):
        packed, static = fused
        key = jax.random.PRNGKey(0)
        img = np.asarray(make_sharded_render_fn(static, mesh)(packed, key))
        ref = np.asarray(jax.jit(lambda p, k: render_frame(p, static, k))(packed, key))
        self._assert_frames_match(img, ref)

    @pytest.mark.slow
    def test_bump_hybrid_matches_single_chip(self, mesh):
        """Bump scenes under the mesh: each shard runs the bump HYBRID
        round-0 (kernel pins + tangent-carrying XLA reshade,
        ops/pallas_grad.build_bump_round0) through parallel/mesh.py's
        build_trace_round0 dispatch — same composition contract as the
        plain fused path."""
        from chess2rt_tpu.models import types as T

        sc = T.Scene()
        w, h = 48, 32
        sc.settings.frameWidth, sc.settings.frameHeight = w, h
        sc.settings.AAEnabled = False
        sc.camera = T.Camera(pos=(0, 60, -120), yaw=0, pitch=-15, fov=90)
        sc.camera.set_frame_size(w, h)
        sc.lights.append(T.PointLight(pos=(60, 180, -60), color=(1, 1, 1), power=40000))
        lam = T.Lambert(name="l", color=(0.7, 0.7, 0.7))
        sc.shaders.append(lam)
        hh, ww = np.mgrid[0:16, 0:16]
        height = (0.5 + 0.5 * np.sin(ww * 0.5) * np.cos(hh * 0.4)).astype(np.float32)
        bt = T.BumpTexture(name="bt", scaling=0.05, data=np.repeat(height[..., None], 3, -1))
        bt.strength = 6.0
        sc.textures.append(bt)
        for name, geom in [
            ("floor", T.Plane(name="p", y=0, limit=200)),
            ("ball", T.Sphere(name="s", center=(0, 40, 30), R=30.0)),
            ("box", T.Cube(name="c", center=(-60, 20, 10), side=30.0)),
        ]:
            sc.geometries.append(geom)
            n = T.Node(name=name, geometry=geom, shader=lam)
            n.bumpmap = bt
            sc.nodes.append(n)
        packed, static = pack_scene(sc, dtype=jnp.float32)
        st = dataclasses.replace(static, use_pallas=True, interpret_pallas=True)
        key = jax.random.PRNGKey(0)
        img = np.asarray(make_sharded_render_fn(st, mesh)(packed, key))
        ref = np.asarray(jax.jit(lambda p, k: render_frame(p, st, k))(packed, key))
        self._assert_frames_match(img, ref)

    @pytest.mark.slow
    def test_bump_hybrid_grads_match_single_chip(self, mesh):
        """Sharded inverse rendering through the bump hybrid: the
        per-shard backward runs the LIN-INPUT bump custom VJP (the one
        input form no single-device test reaches) + psum — loss and
        grads must match the single-device fused VJP."""
        from chess2rt_tpu.models import types as T

        sc = T.Scene()
        w, h = 48, 32
        sc.settings.frameWidth, sc.settings.frameHeight = w, h
        sc.settings.AAEnabled = False
        sc.camera = T.Camera(pos=(0, 60, -120), yaw=0, pitch=-15, fov=90)
        sc.camera.set_frame_size(w, h)
        sc.lights.append(T.PointLight(pos=(60, 180, -60), color=(1, 1, 1), power=40000))
        lam = T.Lambert(name="l", color=(0.7, 0.7, 0.7))
        sc.shaders.append(lam)
        hh, ww = np.mgrid[0:16, 0:16]
        height = (0.5 + 0.5 * np.sin(ww * 0.5) * np.cos(hh * 0.4)).astype(np.float32)
        bt = T.BumpTexture(name="bt", scaling=0.05, data=np.repeat(height[..., None], 3, -1))
        bt.strength = 6.0
        sc.textures.append(bt)
        for name, geom in [
            ("floor", T.Plane(name="p", y=0, limit=200)),
            ("ball", T.Sphere(name="s", center=(0, 40, 30), R=30.0)),
        ]:
            sc.geometries.append(geom)
            n = T.Node(name=name, geometry=geom, shader=lam)
            n.bumpmap = bt
            sc.nodes.append(n)
        packed, static = pack_scene(sc, dtype=jnp.float32)
        st = dataclasses.replace(static, use_pallas=True, interpret_pallas=True)
        key = jax.random.PRNGKey(0)
        target = jnp.zeros((h, w, 3))
        vg = make_sharded_value_and_grad(st, mesh)
        loss, g = vg(packed, target, key)
        l1, g1 = jax.jit(jax.value_and_grad(
            lambda p: ((render_frame(p, st, key) - target) ** 2).mean()
        ))(packed)
        np.testing.assert_allclose(float(loss), float(l1), rtol=1e-5)
        for f in ("light_power", "plane_y", "sphere_center", "mat_color", "bump_strength"):
            va, vb = np.asarray(getattr(g, f)), np.asarray(getattr(g1, f))
            scale = max(np.abs(va).max(), np.abs(vb).max(), 1e-12)
            np.testing.assert_allclose(va, vb, atol=1e-4 * scale, err_msg=f)

    @pytest.mark.slow
    def test_adaptive_aa_matches_single_chip_fused(self, fused, mesh):
        """Sharded fused adaptiveAA: sharded base taps, GLOBAL-frame detect,
        lane-compacted taps within each shard."""
        packed, static = fused
        st = dataclasses.replace(static, aa_adaptive=True)
        key = jax.random.PRNGKey(0)
        img = np.asarray(make_sharded_render_fn(st, mesh)(packed, key))
        ref = np.asarray(jax.jit(lambda p, k: render_frame(p, st, k))(packed, key))
        self._assert_frames_match(img, ref, atol=1e-5)
        # and the mask must actually bite vs the quirk path
        stq = dataclasses.replace(static, aa_adaptive=False)
        quirk = np.asarray(make_sharded_render_fn(stq, mesh)(packed, key))
        assert (img != quirk).any()

    @pytest.mark.slow
    def test_chunk_pixels_honored_per_shard(self, fused, data_dir):
        """chunk_pixels under the mesh (round-3 VERDICT item 2): chunked
        per-shard slabs through the lin-input kernel must reproduce the
        unchunked sharded frame — the distributed-8K memory-bound story."""
        packed, static = fused
        key = jax.random.PRNGKey(0)
        m2 = make_mesh(jax.devices()[:2])  # C = 1024/shard -> real slabs
        ref = np.asarray(make_sharded_render_fn(static, m2)(packed, key))
        stc = dataclasses.replace(static, chunk_pixels=512)
        img = np.asarray(make_sharded_render_fn(stc, m2)(packed, key))
        self._assert_frames_match(img, ref, atol=1e-5)

    @pytest.mark.slow
    def test_adaptive_aa_grads_match_single_chip_fused(self, fused, mesh):
        """The fused ADAPTIVE grad plumbing (shard_loss_fused with a
        stop-gradient mask from the sharded fused base pass + in-trace
        base re-render) vs the single-chip fused adaptive VJP."""
        packed, static = fused
        st = dataclasses.replace(static, aa_adaptive=True)
        key = jax.random.PRNGKey(0)
        target = jnp.zeros((static.height, static.width, 3), jnp.float32)
        loss, g = make_sharded_value_and_grad(st, mesh)(packed, target, key)
        l1, g1 = jax.value_and_grad(
            lambda p: ((render_frame(p, st, key) - target) ** 2).mean()
        )(packed)
        np.testing.assert_allclose(float(loss), float(l1), rtol=1e-5)
        for f in ("light_power", "plane_y", "mat_color", "sphere_center"):
            np.testing.assert_allclose(
                np.asarray(getattr(g, f)), np.asarray(getattr(g1, f)), rtol=1e-4, atol=1e-10
            )

    @pytest.mark.slow
    def test_grads_match_single_chip_fused(self, fused, mesh):
        """Sharded fused inverse rendering: per-shard custom-VJP backward +
        psum must match the single-chip fused value_and_grad."""
        packed, static = fused
        key = jax.random.PRNGKey(0)
        target = jnp.zeros((static.height, static.width, 3), jnp.float32)
        loss, g = make_sharded_value_and_grad(static, mesh)(packed, target, key)
        l1, g1 = jax.value_and_grad(
            lambda p: ((render_frame(p, static, key) - target) ** 2).mean()
        )(packed)
        np.testing.assert_allclose(float(loss), float(l1), rtol=1e-5)
        for f in ("light_power", "plane_y", "mat_color", "sphere_center", "checker_c2"):
            np.testing.assert_allclose(
                np.asarray(getattr(g, f)), np.asarray(getattr(g1, f)), rtol=1e-4, atol=1e-10
            )
        np.testing.assert_allclose(float(g.camera.fov), float(g1.camera.fov), rtol=1e-4)


class TestShardedFusedMC:
    """MC (DoF) and GI modes under the mesh with the fused kernels plugged
    in as tracer overrides (round 4, _fused_trace_fns): render_samples
    keeps its per-shard ray-gen + RNG streams byte-for-byte and only the
    tracer swaps, so fused-vs-XLA sharded frames differ by kernel fp
    only (~1 ulp on these scenes)."""

    @pytest.mark.slow
    def test_dof_sharded_fused_matches_sharded_xla(self, data_dir):
        sc = parse_scene_from_file(str(data_dir / "lecture4.sdl"))
        w, h = 32, 24
        sc.settings.frameWidth, sc.settings.frameHeight = w, h
        sc.camera.set_frame_size(w, h)
        sc.settings.AAEnabled = False
        sc.camera.dof = True
        sc.camera.numSamples = 4
        packed, static = pack_scene(sc, dtype=jnp.float32)
        st_f = dataclasses.replace(static, use_pallas=True, interpret_pallas=True)
        mesh = make_mesh()
        key = jax.random.PRNGKey(0)
        a = np.asarray(make_sharded_render_fn(st_f, mesh)(packed, key))
        b = np.asarray(make_sharded_render_fn(static, mesh)(packed, key))
        assert a.max() > 0.01
        np.testing.assert_allclose(a, b, atol=5e-4)

    @pytest.mark.slow
    def test_gi_sharded_fused_matches_sharded_xla(self, data_dir):
        sc = parse_scene_from_file(str(data_dir / "lecture4.sdl"))
        w, h = 32, 24
        sc.settings.frameWidth, sc.settings.frameHeight = w, h
        sc.camera.set_frame_size(w, h)
        sc.settings.AAEnabled = False
        sc.settings.GIEnabled = True
        sc.settings.pathsPerPixel = 4
        packed, static = pack_scene(sc, dtype=jnp.float32)
        static = dataclasses.replace(static, gi_point_light_direct=True)
        st_f = dataclasses.replace(static, use_pallas=True, interpret_pallas=True)
        mesh = make_mesh()
        key = jax.random.PRNGKey(0)
        a = np.asarray(make_sharded_render_fn(st_f, mesh)(packed, key))
        b = np.asarray(make_sharded_render_fn(static, mesh)(packed, key))
        assert a.max() > 0.01
        np.testing.assert_allclose(a, b, atol=5e-4)


class TestMesh2D:
    """2-D (hosts x chips) mesh (SURVEY.md §5.8, round-2 VERDICT item 6):
    same math as the 1-D mesh; the all-reduce decomposes into two
    stages on real hardware."""

    def test_make_mesh_2d_shape(self):
        from chess2rt_tpu.parallel.mesh import make_mesh_2d

        m = make_mesh_2d()
        assert m.devices.shape == (2, 4)
        assert m.axis_names == ("host", "chip")

    def test_render_bit_identical_to_1d(self, scene, mesh):
        from chess2rt_tpu.parallel.mesh import make_mesh_2d

        packed, static = pack_scene(scene, dtype=jnp.float32)
        key = jax.random.PRNGKey(0)
        a = np.asarray(make_sharded_render_fn(static, mesh)(packed, key))
        b = np.asarray(make_sharded_render_fn(static, make_mesh_2d())(packed, key))
        np.testing.assert_array_equal(a, b)

    def test_grads_match_1d_mesh(self, scene, mesh):
        from chess2rt_tpu.parallel.mesh import make_mesh_2d

        packed, static = pack_scene(scene, dtype=jnp.float32)
        key = jax.random.PRNGKey(0)
        target = jnp.zeros((static.height, static.width, 3), jnp.float32)
        l1, g1 = make_sharded_value_and_grad(static, mesh)(packed, target, key)
        l2, g2 = make_sharded_value_and_grad(static, make_mesh_2d())(packed, target, key)
        np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7)


class TestCheckpointRestart:
    """Mid-run checkpoint save/restore reproduces the uninterrupted loss
    trajectory bit-for-bit (§5.3/§5.4 elastic-restart story)."""

    def test_restart_trajectory_exact(self, scene, mesh, tmp_path):
        import optax

        from chess2rt_tpu.grad.checkpoint import load_pytree, save_pytree

        packed, static = pack_scene(scene, dtype=jnp.float32)
        vg = make_sharded_value_and_grad(static, mesh)
        opt = optax.adam(1e-2)
        key = jax.random.PRNGKey(0)
        target = jnp.zeros((static.height, static.width, 3), jnp.float32)

        @jax.jit
        def step(params, opt_state, k):
            loss, grads = vg(params, target, k)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        params, opt_state = packed, opt.init(packed)
        losses = []
        ck = str(tmp_path / "mid.npz")
        for s in range(3):
            params, opt_state, loss = step(params, opt_state, jax.random.fold_in(key, s))
            losses.append(float(loss))
            if s == 0:
                save_pytree(ck, {"params": params, "opt": opt_state}, step=s)

        snap, _ = load_pytree(ck, {"params": packed, "opt": opt.init(packed)})
        rp, ro = snap["params"], snap["opt"]
        for s in range(1, 3):
            rp, ro, rl = step(rp, ro, jax.random.fold_in(key, s))
            assert float(rl) == losses[s], (s, float(rl), losses[s])


class TestMultiProcess:
    def test_two_process_bringup_matches_in_process(self):
        """REAL jax.distributed bring-up (SURVEY.md §5.8): 2 OS processes +
        TCP coordinator, a global mesh spanning both, one sharded grad
        step — loss and every gradient leaf must match the in-process
        2-device mesh result (per-shard-grad psum => shard-count
        independent math)."""
        from chess2rt_tpu.parallel.mp_dryrun import _build, run_multiprocess_dryrun

        w, h = 17, 3
        packed, static = _build(w, h)
        mesh = make_mesh(jax.devices()[:2])
        vg = make_sharded_value_and_grad(static, mesh)
        target = jnp.zeros((h, w, 3), jnp.float32)
        loss, grads = vg(packed, target, jax.random.PRNGKey(0))

        mp_loss, mp_leaves = run_multiprocess_dryrun(2, width=w, height=h)
        np.testing.assert_allclose(mp_loss, float(loss), rtol=1e-5)
        ref = jax.tree.leaves(grads)
        assert len(mp_leaves) == len(ref)
        for a, b in zip(mp_leaves, ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)

    @pytest.mark.slow
    def test_2x2_hosts_chips_mesh_across_processes(self):
        """The 2-D (hosts x chips) mesh across REAL OS-process boundaries —
        2 processes x 2 local devices, the host psum stage crossing
        processes, the chip stage staying process-local.  Loss + grads must match the
        in-process mesh (per-shard-grad psum => layout independent)."""
        from chess2rt_tpu.parallel.mp_dryrun import _build, run_multiprocess_dryrun

        w, h = 17, 3
        packed, static = _build(w, h)
        vg = make_sharded_value_and_grad(static, make_mesh(jax.devices()[:2]))
        target = jnp.zeros((h, w, 3), jnp.float32)
        loss, grads = vg(packed, target, jax.random.PRNGKey(0))

        mp_loss, mp_leaves = run_multiprocess_dryrun(
            2, width=w, height=h, devices_per_process=2, mesh2d=True
        )
        np.testing.assert_allclose(mp_loss, float(loss), rtol=1e-5)
        ref = jax.tree.leaves(grads)
        assert len(mp_leaves) == len(ref)
        for a, b in zip(mp_leaves, ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)

    @pytest.mark.slow
    def test_pod_scaling_recipe_virtual_mesh(self, tmp_path):
        """The scaling recipe (demos/pod_scaling.py, the one command that
        fills BASELINE.md's scaling row on real hardware) must run end-to-end on the virtual mesh and emit
        well-formed forward+grad rows at every device count."""
        import json
        import os
        import subprocess
        import sys

        out = tmp_path / "scaling.json"
        r = subprocess.run(
            [sys.executable, "demos/pod_scaling.py", "--cpu", "--devices", "8",
             "--size", "96x54", "--repeats", "1", "--out", str(out)],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=1200,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        payload = json.loads(out.read_text())
        rows = payload["rows"]
        assert sorted({row["devices"] for row in rows}) == [1, 2, 4, 8]
        assert {row["mode"] for row in rows} == {"forward", "grad"}
        assert all(row["rays_per_sec"] > 0 for row in rows)
        assert all(row["efficiency_vs_1chip"] > 0 for row in rows)
