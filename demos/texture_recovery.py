"""Texture recovery: reconstruct bitmap texel values from a rendered image.

The showcase for the differentiable texel path (deferred quad gather
forward, sorted scatter-add VJP — ops/shade.quad_gather_flat): render
lecture5 (from $CHESS2RT_DATA_DIR) (bitmap floor + bitmap world sphere +
mirror) as the target, replace the texture atlas with flat gray, then
recover the visible texels with Adam on pixel L2 through the fused
kernel forward and the leaf-pinned custom-VJP backward.

Only texels that the view actually samples receive gradient (standard
inverse rendering); recovery error is therefore reported over the texels
Adam touched, plus the re-rendered image error over ALL pixels.

    python demos/texture_recovery.py --cpu --size 160x120 --steps 60
    python demos/texture_recovery.py                      # GPU defaults
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from chess2rt_tpu.grad import InverseProblem, fit  # noqa: E402
from chess2rt_tpu.models.packed import pack_scene  # noqa: E402
from chess2rt_tpu.render.pipeline import render_frame  # noqa: E402
from chess2rt_tpu.scene.assets import reference_scene  # noqa: E402
from chess2rt_tpu.scene.loader import parse_scene_from_file  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    sc = parse_scene_from_file(reference_scene("lecture5.sdl"))
    sc.settings.frameWidth, sc.settings.frameHeight = w, h
    sc.camera.set_frame_size(w, h)
    sc.settings.AAEnabled = False
    packed, static = pack_scene(sc, dtype=jnp.float32)

    target = render_frame(packed, static, jax.random.PRNGKey(0))
    true_atlas = packed.bitmap_atlas

    # start from flat mid-gray: zero prior knowledge of either bitmap
    wrong = dataclasses.replace(packed, bitmap_atlas=jnp.full_like(true_atlas, 0.5))

    prob = InverseProblem(
        static=static,
        target=target,
        train_fields=("bitmap_atlas",),
        learning_rate=args.lr,
        steps=args.steps,
    )
    log = lambda i, l: (i % 25 == 0) and print(f"step {i}: loss {l:.3e}", flush=True)  # noqa: E731
    t0 = time.perf_counter()
    fitted, losses = fit(wrong, prob, on_step=log)
    dt = time.perf_counter() - t0

    # visible-texel mask: texels whose value Adam actually moved
    moved = np.asarray(jnp.abs(fitted.bitmap_atlas - 0.5) > 1e-4)
    err = np.abs(np.asarray(fitted.bitmap_atlas - true_atlas))
    mae_visible = float(err[moved].mean()) if moved.any() else float("nan")
    frac = float(moved.mean())

    img = render_frame(fitted, static, jax.random.PRNGKey(0))
    img_mae = float(jnp.abs(img - target).mean())
    print(
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e} in {len(losses)} steps "
        f"({dt:.1f}s, {1000*dt/len(losses):.1f} ms/step incl host loop); "
        f"visible texels {100*frac:.1f}% of atlas, MAE {mae_visible:.4f}; "
        f"re-rendered image MAE {img_mae:.5f}",
        flush=True,
    )
    ok = losses[-1] < losses[0] * 0.02 and mae_visible < 0.08 and img_mae < 0.01
    print("RECOVERED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
