"""GI inverse rendering: recover scene parameters THROUGH the path tracer
(differentiating the reference's genuinely recursive mode, renderer.d:378-463, is the north-star extension at its
hardest).

Scene: lecture4 (from $CHESS2RT_DATA_DIR) + a far Lambert bounce wall (the BASELINE GI config), NEE
extension on.  The demo renders a target frame, perturbs the wall albedo
and the light power, and recovers both with Adam on pixel L2 — gradients
flow through every path segment (NEE direct terms + BRDF-sampled
continuations).  It finishes with an on-hardware finite-difference check
on the light-power scale (a GI-smooth parameter: RNG draws are
parameter-independent, so with a fixed key the MC render is a smooth
deterministic function of the parameters).

    python demos/gi_inverse.py --cpu               # quick CPU run
    python demos/gi_inverse.py                     # GPU (fused GI kernel)
    python demos/gi_inverse.py --resample          # per-step fresh keys
                                                   # (SGD on the expected
                                                   # loss; recovers to the
                                                   # MC noise floor)

Default mode fits with ONE fixed key (correlated-sample inverse
rendering): the loss is deterministic-smooth, so recovery is tight.
Exits nonzero unless parameters recover.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from chess2rt_tpu.grad import InverseProblem, fit  # noqa: E402
from chess2rt_tpu.models import types as T  # noqa: E402
from chess2rt_tpu.models.packed import pack_scene  # noqa: E402
from chess2rt_tpu.render.pipeline import render_frame  # noqa: E402
from chess2rt_tpu.scene.assets import reference_scene  # noqa: E402
from chess2rt_tpu.scene.loader import parse_scene_from_file  # noqa: E402


def build(w, h, paths):
    """The BASELINE GI scene: lecture4 + far bounce
    wall, NEE on, depth 5."""
    sc = parse_scene_from_file(reference_scene("lecture4.sdl"))
    sc.settings.frameWidth, sc.settings.frameHeight = w, h
    sc.camera.set_frame_size(w, h)
    sc.settings.AAEnabled = False
    sc.settings.GIEnabled = True
    sc.settings.maxTraceDepth = 5
    sc.settings.pathsPerPixel = paths
    sc.nodes.append(
        T.Node(
            name="wall",
            geometry=T.Sphere(name="w", center=(60, 80, 330), R=50.0),
            shader=T.Lambert(name="white", color=(0.8, 0.8, 0.8)),
        )
    )
    sc.geometries.append(sc.nodes[-1].geometry)
    sc.shaders.append(sc.nodes[-1].shader)
    packed, static = pack_scene(sc, dtype=jnp.float32)
    return sc, packed, dataclasses.replace(static, gi_point_light_direct=True)


def fd_check(packed, static, key):
    """Central-difference check of d(loss)/d(light-power scale) — the
    FD-vs-autodiff anchor, run on the SAME backend the fit used (the f64
    CPU version of this check is tests/test_gi.py::test_gi_gradients_match_fd)."""

    def loss(s):
        p = dataclasses.replace(packed, light_power=packed.light_power * s)
        return (render_frame(p, static, key) ** 2).mean()

    g = float(jax.jit(jax.grad(loss))(jnp.float32(1.0)))
    h = 1e-2  # f32 central diff: truncation ~h^2, rounding ~eps/h
    fd = (float(jax.jit(loss)(jnp.float32(1.0 + h))) - float(jax.jit(loss)(jnp.float32(1.0 - h)))) / (2 * h)
    rel = abs(g - fd) / max(abs(fd), 1e-12)
    print(f"FD check (light power): autodiff {g:.6e} vs central-diff {fd:.6e} (rel {rel:.2e})")
    return rel < 2e-2 and g != 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="160x120")
    ap.add_argument("--paths", type=int, default=16)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--resample", action="store_true",
                    help="fresh key per step (SGD on the expected loss)")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    sc, packed, static = build(w, h, args.paths)
    key = jax.random.PRNGKey(7)
    if args.resample:
        # fresh-key SGD minimizes E_k[(render_k(p) - target)^2]; a single
        # noisy target displaces that optimum by O(target noise), so give
        # it a converged target (average of 8 independent realizations)
        tkeys = jax.random.split(jax.random.PRNGKey(1007), 8)
        target = jnp.mean(
            jax.lax.map(lambda k: render_frame(packed, static, k), tkeys), axis=0
        )
    else:
        target = render_frame(packed, static, key)
    print(f"# backend {jax.default_backend()}; {w}x{h}, {args.paths} paths/px, depth 5, NEE on")

    wall_idx = len(sc.nodes) - 1
    wrong = dataclasses.replace(
        packed,
        mat_color=packed.mat_color.at[wall_idx].mul(0.4),
        light_power=packed.light_power * 2.0,
    )

    log = lambda i, l: (i % 25 == 0) and print(f"step {i}: loss {l:.3e}")  # noqa: E731
    prob = InverseProblem(
        static=static, target=target, train_fields=("mat_color", "light_power"),
        learning_rate=4e-2, steps=args.steps, resample_keys=args.resample,
        # light power is O(5e4) while albedo is O(1): give its Adam
        # updates a matching scale or it moves 0.04/step (frozen)
        update_scales={"light_power": 2e4},
        # fresh-key SGD needs a decaying step to converge through the MC
        # noise floor; the fixed-key fit is deterministic (constant lr)
        lr_decay_to=0.1 if args.resample else 1.0,
    )
    fitted, losses = fit(wrong, prob, key=key, on_step=log)

    err_albedo = float(jnp.abs(fitted.mat_color[wall_idx] - packed.mat_color[wall_idx]).max())
    err_power = float(
        jnp.abs(fitted.light_power - packed.light_power).max()
        / jnp.abs(packed.light_power).max()
    )
    print(
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e}; wall albedo err {err_albedo:.4f} "
        f"(true {np.asarray(packed.mat_color[wall_idx])}); light power rel err {err_power:.4f}"
    )

    fd_ok = fd_check(packed, static, key)
    # resample mode: the per-step loss carries the fresh-key MC variance
    # as an irreducible floor, so the loss ratio only needs to reach that
    # floor — the parameter errors are the real recovery criterion
    tol = 0.08 if args.resample else 0.02
    loss_ratio = 0.25 if args.resample else 0.02
    ok = (
        losses[-1] < losses[0] * loss_ratio
        and err_albedo < tol
        and err_power < tol
        and fd_ok
    )
    print("RECOVERED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
