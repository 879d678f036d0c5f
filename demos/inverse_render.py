"""Inverse rendering demo (BASELINE config #5).

Renders a target frame from lecture4 (from $CHESS2RT_DATA_DIR) + a red sphere, perturbs material
colors, light power, and the sphere position, then recovers them with
Adam on pixel L2 — optionally sharded over all visible devices
(--distributed).  Prints recovery errors; exits nonzero on failure.

    JAX_PLATFORMS=cpu python demos/inverse_render.py          # quick CPU run
    python demos/inverse_render.py --distributed               # GPU(s) / mesh
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="64x48")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    sc = parse_scene_from_file(reference_scene("lecture4.sdl"))
    sc.settings.frameWidth, sc.settings.frameHeight = w, h
    sc.camera.set_frame_size(w, h)
    sc.settings.AAEnabled = False
    sc.nodes.append(
        T.Node(
            name="ball",
            geometry=T.Sphere(name="b", center=(0.0, 60.0, 350.0), R=40.0),
            shader=T.Lambert(name="red", color=(0.9, 0.1, 0.1)),
        )
    )
    packed, static = pack_scene(sc, dtype=jnp.float32)
    target = render_frame(packed, static, jax.random.PRNGKey(0))

    # perturb: material colors x0.4, sphere shifted 10 units (~0.7 px at its
    # distance) (BASELINE
    # config #5: "recover material colors + sphere positions"; light power
    # is left alone — color x power is a non-identifiable product)
    wrong = dataclasses.replace(
        packed,
        mat_color=packed.mat_color * 0.4,
        checker_c2=packed.checker_c2 * 0.4,
        sphere_center=packed.sphere_center + jnp.asarray([[10.0, 0.0, 0.0]]),
    )

    mesh = None
    if args.distributed:
        from chess2rt_tpu.parallel import make_mesh

        mesh = make_mesh()
        print(f"mesh: {mesh.devices.size} devices")

    log = lambda i, l: (i % 25 == 0) and print(f"step {i}: loss {l:.3e}")  # noqa: E731

    # Alternate color and geometry phases (block-coordinate descent):
    # colors take small steps, positions move in world units and need a
    # ~10x larger step; alternating stops either from overfitting to the
    # other's current error.
    losses = []
    fitted = wrong
    color_prob = InverseProblem(
        static=static, target=target, train_fields=("mat_color", "checker_c2"),
        learning_rate=5e-2, steps=args.steps // 3, mesh=mesh,
    )
    pos_prob = dataclasses.replace(color_prob, train_fields=("sphere_center",), learning_rate=0.5)
    for phase in range(3):
        fitted, l1 = fit(fitted, color_prob, on_step=log)
        fitted, l2 = fit(fitted, pos_prob, on_step=log)
        losses += l1 + l2
        print(f"-- alternation {phase}: loss {losses[-1]:.3e}")

    # the floor's mat_color never touches the image (checker-textured,
    # shader.d:74-76) and keeps zero gradient — compare the ball's only
    ball_idx = len(sc.nodes) - 1
    err_color = float(jnp.abs(fitted.mat_color[ball_idx] - packed.mat_color[ball_idx]).max())
    err_checker = float(jnp.abs(fitted.checker_c2 - packed.checker_c2).max())
    err_pos = float(jnp.abs(fitted.sphere_center - packed.sphere_center).max())
    print(
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e}; ball color err {err_color:.3f}; "
        f"checker err {err_checker:.3f}; sphere pos err {err_pos:.2f} (from 10.0)"
    )
    ok = losses[-1] < losses[0] * 0.05 and err_color < 0.1 and err_checker < 0.1 and err_pos < 5.0
    print("RECOVERED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
