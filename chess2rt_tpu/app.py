"""CLI entry point: headless render to BMP.

Parity with the reference app surface (app.d:9-39, gui/raytracer_demo.d):
* ``--file=<scene>`` flag (app.d:15); when omitted, the default scene is
  resolved like RTDemo.getPathToDefaultScene (raytracer_demo.d:19-42):
  ``$CHESS2RT_DATA_DIR`` + the scene path named by ``default_scene.path``,
  or the in-repo ``scenes/flagship.sdl`` when the variable is unset.
* the scene is pretty-printed after load (Scene.toString dump,
  raytracer_demo.d:156).
* screenshots go to ``output/img_<ISO-time>.bmp`` with the reference's
  naming scheme (raytracer_demo.d:227-238) when no --output is given.
* ``--debug-pixel X,Y`` reproduces the left-click single-pixel trace dump
  (renderer.d:46-57, raytracer_demo.d:240-266) — ray, hit node, distance,
  color, hit point, normal, UV — tracing the DEVICE pipeline at the chosen
  dtype side by side with the float64 oracle, so device/oracle
  disagreements are directly visible.

* ``--interactive`` runs a real progressive viewer (gui/viewer.py): SDL2
  window when pysdl2 is importable, 24-bit ANSI terminal otherwise, with
  the prepass-then-zigzag-buckets display order (renderer.d:110-127,
  :194-213) and the RTDemo control table.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def default_scene_path() -> str:
    """``$CHESS2RT_DATA_DIR`` + the scene named by its ``default_scene.path``
    when that variable is set; otherwise the in-repo flagship scene."""
    data_dir = os.environ.get("CHESS2RT_DATA_DIR")
    if not data_dir:
        from .scene.assets import flagship_scene_path

        return flagship_scene_path()
    pointer = os.path.join(data_dir, "default_scene.path")
    with open(pointer) as f:
        rel = f.read().strip()
    return os.path.join(data_dir, rel)


def screenshot_name() -> str:
    # img_<ISO-8601, ':' replaced>.bmp (raytracer_demo.d:44-53)
    stamp = time.strftime("%Y-%m-%dT%H.%M.%S")
    return os.path.join("output", f"img_{stamp}.bmp")


def _oracle_pixel_trace(scene, x: int, y: int):
    """Oracle-side single-pixel fields (float64 numpy reference)."""
    import numpy as np

    from .oracle.renderer import OracleRenderer, get_screen_rays

    r = OracleRenderer(scene)
    orig, dir = get_screen_rays(scene.camera, r.frame, np.array([float(x)]), np.array([float(y)]))
    rec, win = r.closest_hit(orig, dir)
    color = r.raytrace(orig, dir)
    return {
        "orig": orig[0],
        "dir": dir[0],
        "win": int(win[0]),
        "dist": float(rec.dist[0]),
        "color": color[0],
        "p": rec.p[0],
        "normal": rec.normal[0],
        "uv": (float(rec.u[0]), float(rec.v[0])),
    }


def _device_pixel_trace(scene, x: int, y: int, dtype_str: str = "f32"):
    """Device-side single-pixel fields: the ACTUAL render pipeline
    (render/pipeline.py) run eagerly on a one-ray batch at the requested
    dtype — raytracer_demo.d:240-266 inspects what the renderer did, not a
    reference re-derivation, and so does this."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    if dtype_str == "f64":
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if dtype_str == "f64" else jnp.float32

    from .models.packed import pack_scene
    from .ops import geometry as G
    from .ops.camera import begin_frame, screen_rays
    from .render.pipeline import render_samples

    packed, static = pack_scene(scene, dtype=dtype)
    frame = begin_frame(packed.camera, static.width / static.height)
    xs = jnp.asarray([float(x)], dtype=dtype)
    ys = jnp.asarray([float(y)], dtype=dtype)
    orig, dir = screen_rays(packed.camera, frame, float(static.width), float(static.height), xs, ys, 0.0)
    hit, win = G.scene_closest(packed, static, orig, dir)
    color = render_samples(packed, static, frame, xs, ys, jax.random.PRNGKey(0))
    f = lambda a: np.asarray(a)  # noqa: E731
    return {
        "orig": f(orig)[0],
        "dir": f(dir)[0],
        "win": int(f(win)[0]),
        "dist": float(f(hit["dist"])[0]),
        "color": f(color)[0],
        "p": f(hit["p"])[0],
        "normal": f(hit["normal"])[0],
        "uv": (float(f(hit["u"])[0]), float(f(hit["v"])[0])),
    }


def debug_pixel(scene, x: int, y: int, dtype_str: str = "f32") -> str:
    """Single-pixel trace dump (parity: raytracer_demo.d:247-265), printing
    the DEVICE pipeline's trace side by side with the float64 oracle —
    when the two disagree (exactly when you need this tool) both are
    visible."""
    dev = _device_pixel_trace(scene, x, y, dtype_str)
    orc = _oracle_pixel_trace(scene, x, y)

    def v3(a):
        return f"({a[0]:.6g}, {a[1]:.6g}, {a[2]:.6g})"

    def node_desc(win):
        if win < 0:
            return "miss (environment)"
        node = scene.nodes[win]
        return (
            f"'{node.name}' geometry={type(node.geometry).__name__} "
            f"shader={type(node.shader).__name__}"
        )

    rows = [
        ("Ray origin", v3(dev["orig"]), v3(orc["orig"])),
        ("Ray direction", v3(dev["dir"]), v3(orc["dir"])),
        ("Hit node", node_desc(dev["win"]), node_desc(orc["win"])),
    ]
    if dev["win"] >= 0 or orc["win"] >= 0:
        rows += [
            ("Distance", f"{dev['dist']:.6g}", f"{orc['dist']:.6g}"),
            ("Hit point", v3(dev["p"]), v3(orc["p"])),
            ("Normal", v3(dev["normal"]), v3(orc["normal"])),
            ("UV", f"({dev['uv'][0]:.6g}, {dev['uv'][1]:.6g})", f"({orc['uv'][0]:.6g}, {orc['uv'][1]:.6g})"),
        ]
    rows.append(("Color", v3(dev["color"]), v3(orc["color"])))

    wl = max(len(r[0]) for r in rows)
    wd = max(len(r[1]) for r in rows)
    lines = [
        f"Mouse click at: ({x}, {y})",
        f"  {'':{wl}}   {'device (' + dtype_str + ')':{wd}}   oracle (f64)",
    ]
    for name, d, o in rows:
        marker = "" if d == o else "   <- differs"
        lines.append(f"  {name:{wl}}   {d:{wd}}   {o}{marker}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chess2rt_tpu", description=__doc__.split("\n")[0])
    ap.add_argument("--file", default=None, help="scene file (.sdl or .json)")
    ap.add_argument("--output", "-o", default=None, help="output BMP path (default: output/img_<time>.bmp)")
    ap.add_argument("--size", default=None, help="override frame size, WxH")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--backend", choices=["jax", "oracle"], default="jax",
                    help="jax = the device pipeline; oracle = the float64 numpy reference")
    ap.add_argument("--distributed", action="store_true", help="shard pixels over all visible devices")
    ap.add_argument("--debug-pixel", default=None, metavar="X,Y",
                    help="dump a single-pixel trace (click-to-inspect parity) and exit")
    ap.add_argument("--interactive", action="store_true",
                    help="progressive viewer + WASD camera drive (SDL2 window "
                         "when pysdl2 is importable, 24-bit ANSI terminal otherwise)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", "-q", action="store_true", help="skip the scene dump")
    ap.add_argument("--stats", action="store_true", help="print per-frame timing")
    ap.add_argument("--log-json", default=None, metavar="PATH",
                    help="append structured JSON-lines event records (scene "
                         "load, frame timing) to PATH ('-' = stderr)")
    args = ap.parse_args(argv)

    if args.distributed:
        # multi-process bring-up must precede the first backend-initializing
        # JAX call (jax.distributed contract); a single process drives every
        # local device and needs none (SURVEY.md §5.8).
        from .parallel import distributed

        distributed.initialize_distributed()

    from .scene.assets import FLAGSHIP_SCENE, ensure_flagship_textures
    from .scene.loader import parse_scene_from_file
    from .utils import structlog
    from .utils.cache import enable_compile_cache

    enable_compile_cache()

    if args.log_json:
        stream = sys.stderr if args.log_json == "-" else open(args.log_json, "a")
        structlog.configure(stream=stream)
    log = structlog.get_logger()

    path = args.file or default_scene_path()
    if os.path.abspath(path) == str(FLAGSHIP_SCENE):
        ensure_flagship_textures()
    scene = parse_scene_from_file(path)
    log.emit("scene_loaded", path=path, nodes=len(scene.nodes), lights=len(scene.lights))

    if args.size:
        w, h = (int(v) for v in args.size.lower().split("x"))
        scene.settings.frameWidth, scene.settings.frameHeight = w, h
        scene.camera.set_frame_size(w, h)

    if not args.quiet:
        print(f"Loading scene: {path}")
        print(scene.pretty())

    if args.debug_pixel:
        x, y = (int(v) for v in args.debug_pixel.split(","))
        print(debug_pixel(scene, x, y, args.dtype))
        return 0

    if args.interactive:
        import jax.numpy as jnp

        from .gui.viewer import interactive_main

        dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
        return interactive_main(path, dtype=dtype)

    t0 = time.perf_counter()
    frame_rec = {"scene": path, "backend": args.backend, "dtype": args.dtype,
                 "width": scene.settings.frameWidth, "height": scene.settings.frameHeight}
    if args.backend == "oracle":
        from .oracle import render_scene

        img = render_scene(scene, seed=args.seed)
    else:
        import jax
        import jax.numpy as jnp

        dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
        if args.dtype == "f64":
            jax.config.update("jax_enable_x64", True)
        key = jax.random.PRNGKey(args.seed)
        # chess2rt_tpu/dispatch.py runs the fused kernel where the backend
        # compiles it and the scene is covered (f64 stays on XLA)
        if args.distributed:
            from .models.packed import pack_scene
            from .parallel import make_mesh, render_frame_distributed

            packed, static = pack_scene(scene, dtype=dtype)
            img = render_frame_distributed(packed, static, make_mesh(), key)
        else:
            from .render.pipeline import render_scene_jax

            img = render_scene_jax(scene, dtype=dtype, key=key)
        import numpy as np

        img = np.asarray(jax.block_until_ready(img))
    dt = time.perf_counter() - t0
    log.emit("frame", wall_ms=round(dt * 1e3, 3), **frame_rec)

    out_path = args.output or screenshot_name()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    from .imageio.bmp import save_bmp_file

    save_bmp_file(out_path, img)
    print(f"Saved {scene.settings.frameWidth}x{scene.settings.frameHeight} render to {out_path}")
    if args.stats:
        npx = scene.settings.frameWidth * scene.settings.frameHeight
        print(f"Frame time: {dt:.3f} s ({npx/dt/1e6:.2f} Mpx/s, backend={args.backend})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
