"""BASELINE config #4: zaphod full scene + cubemap skybox + bitmap textures.

The data/ tree ships no cubemap faces, so this demo synthesizes a sky
gradient cubemap (horizon haze -> zenith blue), attaches it to the zaphod
scene's Environment (the reference's miss-shader hook, environment.d:5-15,
completed by ops/env.py), and renders at the requested size.

    python demos/zaphod_skybox.py --size 1920x1080 -o zaphod_sky.bmp
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def make_sky_cubemap(size: int = 64) -> np.ndarray:
    """[6, S, S, 3] gradient sky: +Y face zenith blue, side faces blend to
    a warm horizon, -Y ground haze."""
    zenith = np.array([0.20, 0.45, 0.85], np.float32)
    horizon = np.array([0.85, 0.80, 0.70], np.float32)
    ground = np.array([0.25, 0.22, 0.20], np.float32)
    t = np.linspace(0, 1, size, dtype=np.float32)[:, None, None]
    faces = np.zeros((6, size, size, 3), np.float32)
    side = horizon * (t) + zenith * (1 - t)  # v=0 top -> zenith
    for f in (0, 1, 4, 5):
        faces[f] = side
    faces[2] = zenith  # +Y
    faces[3] = ground  # -Y
    return faces


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="640x430")
    ap.add_argument("-o", "--output", default="zaphod_sky.bmp")
    ap.add_argument("--samples", type=int, default=None, help="override DoF samples")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--xla", action="store_true",
                    help="use the pure-XLA pipeline instead of the fused Pallas "
                         "ray-input kernel")
    ap.add_argument("--adaptive-aa", action="store_true",
                    help="honor the needs-AA mask (adaptiveAA extension): the 4 "
                         "AA taps — each a full 25-sample DoF loop — run "
                         "lane-compacted at flagged-pixel width")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from chess2rt_tpu.imageio import save_image
    from chess2rt_tpu.models.packed import pack_scene
    from chess2rt_tpu.render.pipeline import render_frame
    from chess2rt_tpu.scene.assets import reference_scene
    from chess2rt_tpu.scene.loader import parse_scene_from_file

    sc = parse_scene_from_file(reference_scene("zaphod.sdl"))
    sc.settings.frameWidth, sc.settings.frameHeight = w, h
    sc.camera.set_frame_size(w, h)
    if args.samples:
        sc.camera.numSamples = args.samples
    sc.environment.cubemap = make_sky_cubemap()

    packed, static = pack_scene(sc)
    import dataclasses

    if args.xla:
        static = dataclasses.replace(static, use_pallas=False)
    if args.adaptive_aa:
        static = dataclasses.replace(static, aa_adaptive=True)
    fn = jax.jit(lambda p, k: render_frame(p, static, k))
    t0 = time.perf_counter()
    img = np.asarray(jax.block_until_ready(fn(packed, jax.random.PRNGKey(0))))
    dt = time.perf_counter() - t0
    save_image(args.output, img)
    sky = img[0].mean(axis=0)
    print(f"rendered {w}x{h} in {dt:.2f}s (incl. compile) -> {args.output}")
    t0 = time.perf_counter()
    jax.block_until_ready(fn(packed, jax.random.PRNGKey(1)))
    print(f"steady-state frame: {time.perf_counter() - t0:.2f}s")
    print(f"sky row mean RGB: {sky.round(3)} (non-black => cubemap active)")
    assert img[0].max() > 0.05, "sky should show the cubemap"
    return 0


if __name__ == "__main__":
    sys.exit(main())
