"""Inverse rendering (grad/) tests: parameter recovery, masking,
checkpoint/resume."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chess2rt_tpu.grad import InverseProblem, fit, load_pytree, save_pytree
from chess2rt_tpu.models.packed import pack_scene
from chess2rt_tpu.render.pipeline import render_frame
from chess2rt_tpu.scene.loader import parse_scene_from_file


@pytest.fixture(scope="module")
def setup(data_dir):
    sc = parse_scene_from_file(str(data_dir / "lecture4.sdl"))
    sc.settings.frameWidth, sc.settings.frameHeight = 24, 16
    sc.camera.set_frame_size(24, 16)
    sc.settings.AAEnabled = False
    packed, static = pack_scene(sc, dtype=jnp.float32)
    target = render_frame(packed, static, jax.random.PRNGKey(0))
    return packed, static, target


class TestFit:
    def test_recovers_checker_color(self, setup):
        packed, static, target = setup
        # perturb the checker's second color and recover it
        wrong = dataclasses.replace(packed, checker_c2=packed.checker_c2 * 0.3)
        prob = InverseProblem(
            static=static, target=target, train_fields=("checker_c2",), learning_rate=5e-2, steps=60
        )
        fitted, losses = fit(wrong, prob)
        assert losses[-1] < losses[0] * 0.05
        np.testing.assert_allclose(
            np.asarray(fitted.checker_c2), np.asarray(packed.checker_c2), atol=0.05
        )

    def test_recovers_light_power(self, setup):
        packed, static, target = setup
        wrong = dataclasses.replace(packed, light_power=packed.light_power * 0.4)
        # optimize in a well-scaled space by training power via its gradient
        prob = InverseProblem(
            static=static, target=target, train_fields=("light_power",), learning_rate=2e3, steps=80
        )
        fitted, losses = fit(wrong, prob)
        assert losses[-1] < losses[0] * 0.1
        np.testing.assert_allclose(
            float(fitted.light_power[0]), float(packed.light_power[0]), rtol=0.05
        )

    def test_update_scales_mixed_magnitudes(self, data_dir):
        """Joint recovery of O(1) albedo + O(5e4) light power with ONE
        pixel-scale lr: per-field update_scales give light_power an
        Adam step matched to its magnitude (demos/gi_inverse.py relies
        on this — without it the power moves ~lr/step, i.e. frozen).
        A Lambert ball supplies the trained albedo while the FIXED
        checker floor pins the power (training the checker colors too
        would leave only the power*albedo product observable)."""
        from chess2rt_tpu.models import types as T

        sc = parse_scene_from_file(str(data_dir / "lecture4.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 32, 24
        sc.camera.set_frame_size(32, 24)
        sc.settings.AAEnabled = False
        sc.nodes.append(T.Node(
            name="ball",
            geometry=T.Sphere(name="b", center=(0.0, 60.0, 150.0), R=40.0),
            shader=T.Lambert(name="red", color=(0.9, 0.2, 0.1)),
        ))
        packed, static = pack_scene(sc, dtype=jnp.float32)
        target = render_frame(packed, static, jax.random.PRNGKey(0))
        wrong = dataclasses.replace(
            packed,
            mat_color=packed.mat_color * 0.4,
            light_power=packed.light_power * 1.6,
        )
        prob = InverseProblem(
            static=static, target=target,
            train_fields=("mat_color", "light_power"),
            learning_rate=4e-2, steps=150,
            update_scales={"light_power": 1e4},
        )
        fitted, losses = fit(wrong, prob)
        assert losses[-1] < losses[0] * 0.02
        np.testing.assert_allclose(
            float(fitted.light_power[0]), float(packed.light_power[0]), rtol=0.05
        )
        # the ball's row; other mat_color rows belong to off-screen
        # Lamberts (zero pixel gradient — unrecoverable by construction)
        np.testing.assert_allclose(
            np.asarray(fitted.mat_color[-1]), np.asarray(packed.mat_color[-1]), atol=0.06
        )

    def test_grad_masking_freezes_other_fields(self, setup):
        packed, static, target = setup
        wrong = dataclasses.replace(packed, checker_c2=packed.checker_c2 * 0.5)
        prob = InverseProblem(
            static=static, target=target, train_fields=("checker_c2",), learning_rate=5e-2, steps=3
        )
        fitted, _ = fit(wrong, prob)
        np.testing.assert_array_equal(np.asarray(fitted.light_power), np.asarray(packed.light_power))
        np.testing.assert_array_equal(np.asarray(fitted.plane_y), np.asarray(packed.plane_y))
        np.testing.assert_array_equal(
            np.asarray(fitted.camera.fov), np.asarray(packed.camera.fov)
        )


class TestSpherePositionRecovery:
    def _scene(self, data_dir):
        from chess2rt_tpu.models import types as T

        sc = parse_scene_from_file(str(data_dir / "lecture4.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 32, 24
        sc.camera.set_frame_size(32, 24)
        sc.settings.AAEnabled = False
        ball = T.Node(
            name="ball",
            geometry=T.Sphere(name="b", center=(0.0, 60.0, 150.0), R=40.0),
            shader=T.Lambert(name="red", color=(0.9, 0.1, 0.1)),
        )
        sc.nodes.append(ball)
        return pack_scene(sc, dtype=jnp.float32)

    def test_recover_sphere_center(self, data_dir):
        """BASELINE config #5: geometry positions are trainable through the
        smooth shading terms.  Silhouette pixels are piecewise-constant in
        position (gradient zero — the documented differentiable-rendering
        compromise, SURVEY.md §7.0), so recovery is validated for a small
        displacement where interior shading dominates the loss."""
        packed, static = self._scene(data_dir)
        target = render_frame(packed, static, jax.random.PRNGKey(0))

        moved = dataclasses.replace(
            packed, sphere_center=packed.sphere_center + jnp.asarray([[1.5, 0.0, 0.0]])
        )
        prob = InverseProblem(
            static=static, target=target, train_fields=("sphere_center",), learning_rate=0.2, steps=150
        )
        fitted, losses = fit(moved, prob)
        assert losses[-1] < losses[0] * 0.75
        # must recover most of the 1.5-unit offset
        err = abs(float(fitted.sphere_center[0, 0]) - float(packed.sphere_center[0, 0]))
        assert err < 0.75, err

    def test_sphere_center_grad_matches_fd(self, data_dir):
        """Sub-pixel FD check on the position gradient (BASELINE:
        'gradients verified against finite differences' — geometry params
        checked at perturbations that keep the discrete structure fixed)."""
        packed, static = self._scene(data_dir)
        target = render_frame(packed, static, jax.random.PRNGKey(0)) * 0.9
        key = jax.random.PRNGKey(0)

        def loss_cx(cx):
            p = dataclasses.replace(
                packed, sphere_center=packed.sphere_center.at[0, 0].set(cx)
            )
            return ((render_frame(p, static, key) - target) ** 2).mean()

        c0 = packed.sphere_center[0, 0]
        g = jax.grad(loss_cx)(c0)
        h = 0.05
        fd = (loss_cx(c0 + h) - loss_cx(c0 - h)) / (2 * h)
        # FD crosses silhouette boundaries the analytic grad can't see, so
        # agreement is approximate but must have the right sign + magnitude
        np.testing.assert_allclose(float(g), float(fd), rtol=0.35)


class TestCheckpoint:
    def test_save_load_roundtrip(self, setup, tmp_path):
        packed, _, _ = setup
        p = str(tmp_path / "ckpt.npz")
        save_pytree(p, packed, step=7)
        loaded, step = load_pytree(p, packed)
        assert step == 7
        for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(packed)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_fit_resume(self, setup, tmp_path):
        packed, static, target = setup
        ck = str(tmp_path / "fit.npz")
        wrong = dataclasses.replace(packed, checker_c2=packed.checker_c2 * 0.3)
        prob = dataclasses.replace(
            InverseProblem(static=static, target=target, train_fields=("checker_c2",),
                           learning_rate=5e-2, steps=10),
            checkpoint_path=ck, checkpoint_every=5,
        )
        fit(wrong, prob)
        assert os.path.exists(ck)
        # resuming continues from step 10 (i.e. performs 10 more steps up to 20)
        prob2 = dataclasses.replace(prob, steps=20)
        fitted2, losses2 = fit(wrong, prob2)
        assert len(losses2) == 10  # steps 10..19 only


class TestTexelGrad:
    """ops/shade.quad_gather_flat: the scatter-add texel VJP through a whole
    frame agrees with a finite difference."""

    def test_texel_grad_matches_fd(self, data_dir):
        import dataclasses

        from chess2rt_tpu.render.pipeline import render_frame

        sc = parse_scene_from_file(str(data_dir / "lecture5.sdl"))
        sc.settings.frameWidth, sc.settings.frameHeight = 40, 30
        sc.camera.set_frame_size(40, 30)
        sc.settings.AAEnabled = False
        packed, static = pack_scene(sc, dtype=jnp.float32)
        key = jax.random.PRNGKey(0)

        def lf(p):
            return (render_frame(p, static, key) ** 2).mean()

        a = np.asarray(jax.grad(lf)(packed).bitmap_atlas)
        assert np.abs(a).sum() > 0  # texel grads actually flow

        # FD check one well-hit texel
        idx = np.unravel_index(np.abs(a).argmax(), a.shape)
        eps = 1e-2
        atlas = np.asarray(packed.bitmap_atlas)
        up = atlas.copy(); up[idx] += eps
        dn = atlas.copy(); dn[idx] -= eps
        f_up = float(lf(dataclasses.replace(packed, bitmap_atlas=jnp.asarray(up))))
        f_dn = float(lf(dataclasses.replace(packed, bitmap_atlas=jnp.asarray(dn))))
        fd = (f_up - f_dn) / (2 * eps)
        np.testing.assert_allclose(a[idx], fd, rtol=2e-2)


def test_all_grad_leaves_finite_flagship(data_dir):
    """EVERY ScenePacked gradient leaf must be finite on the flagship
    scene (textured sphere + CSG + mirror).  Round-2 regression: arcsin /
    arctan2 pole hits on the globe produced NaN derivatives that poisoned
    sphere and camera gradients (ops/geometry._safe_arcsin/_safe_arctan2
    clamp the UV-singularity derivative, forward exact)."""
    import dataclasses

    from chess2rt_tpu.models import types as T
    from chess2rt_tpu.render.pipeline import render_frame

    sc = parse_scene_from_file(str(data_dir / "lecture5.sdl"))
    sc.settings.frameWidth, sc.settings.frameHeight = 64, 48
    sc.camera.set_frame_size(64, 48)
    sc.settings.AAEnabled = False
    m = T.Reflection(name="m", color=(0.9, 0.9, 0.9))
    sc.shaders.append(m)
    sc.nodes.append(
        T.Node(name="mb", geometry=T.Sphere(name="mbs", center=(0, 60, 360), R=55.0), shader=m)
    )
    packed, static = pack_scene(sc, dtype=jnp.float32)
    static = dataclasses.replace(static, bounce_capacity=64 * 48 // 4)
    l, g = jax.value_and_grad(
        lambda p: (render_frame(p, static, jax.random.PRNGKey(0)) ** 2).mean()
    )(packed)
    assert np.isfinite(float(l))
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        assert np.isfinite(np.asarray(leaf)).all(), jax.tree_util.keystr(path)
    # the globe's geometry gradients actually flow (not just finite zeros)
    assert np.abs(np.asarray(g.sphere_r)).sum() > 0
