"""Smoke test of the renderer on one NVIDIA GPU (or, with --multi-gpu, the
sharded path on four).

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --multi-gpu  # four cards: the mesh path only

Phases (any failure exits non-zero, and nothing is printed as a result):

* device   — JAX must see a GPU; prints the card's name and power limit,
             the JAX version and the matmul precision in force.
* cli      — ``chess2rt_tpu.app.main`` renders scenes/flagship.sdl at
             1920x1080, depth 5, AA5 to a BMP, in this process.
* oracle   — 96x54 device f32 frames (fused kernel and XLA wavefront)
             against the float64 numpy oracle: >= 99% of u8 pixels within 1.
* kernel   — the compiled fused kernel against the XLA wavefront at 480x272
             and at 1920x1080, and the adaptive-AA pair at 480x272.
* bump, gi — one small bump-mapped frame and one small path-traced frame
             through both paths.
* grad     — one jitted value-and-grad step at 640x480 with texel gradients
             on is finite and non-zero; ``grad.fit`` takes 3 finite Adam
             steps (320x240, one bounce, XLA wavefront).
* timing   — steady-state medians (compile excluded, scalar readback) of the
             flagship frame and the 640x480 grad step through each path,
             and of the texel gather with its VJP; printed, not gated.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "smoke")  # git-ignored
REPEATS = 10


class PhaseFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def card_line():
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip() or f"nvidia-smi rc={r.returncode}: {r.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def median_ms(fn, *args, repeats=REPEATS):
    """(first-call s, median ms, q1 ms, q3 ms) of ``fn(*args)``; each call
    waits for every output and reads one scalar back to the host.  The
    first call compiles unless an earlier phase already did."""
    import jax
    import numpy as np

    def run():
        out = jax.block_until_ready(fn(*args))
        float(jax.tree.leaves(out)[0].reshape(-1)[0])  # one element, not the array

    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        ts.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    return first, med, q1, q3


def fmt_time(name, r, card):
    first, med, q1, q3 = r
    return (f"  {name}: median {med:.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}, n={REPEATS}; "
            f"first call {first:.1f} s) [{card}]")


def frames_close(a, b):
    """(relative checksum delta, fraction within 2e-3 abs + 2e-3 rel)."""
    import numpy as np

    rel = abs(float(a.sum()) - float(b.sum())) / max(abs(float(b.sum())), 1e-9)
    close = float(np.mean(np.abs(a - b) <= 2e-3 + 2e-3 * np.abs(b)))
    return rel, close


def flagship(w, h, aa=True):
    from chess2rt_tpu.models.packed import pack_scene
    from chess2rt_tpu.scene.assets import load_flagship

    import jax.numpy as jnp

    return pack_scene(load_flagship(w, h, aa=aa), dtype=jnp.float32)


def xla_static(static):
    """The XLA-wavefront twin of a scene structure (the fused kernel is the
    default on the GPU)."""
    return dataclasses.replace(static, use_pallas=False)


_JITTED = {}


def render_fn(static):
    """Jitted ``packed -> frame``, one per scene structure (phases share
    compiles)."""
    import jax

    from chess2rt_tpu.render.pipeline import render_frame

    if ("render", static) not in _JITTED:
        key = jax.random.PRNGKey(0)
        _JITTED["render", static] = jax.jit(lambda p: render_frame(p, static, key))
    return _JITTED["render", static]


def loss_grad_fn(static):
    """Jitted value-and-grad of the pixel L2 loss against a black target,
    one per scene structure."""
    import jax
    import jax.numpy as jnp

    from chess2rt_tpu.render.pipeline import render_frame

    if ("grad", static) not in _JITTED:
        key = jax.random.PRNGKey(0)
        target = jnp.zeros((static.height, static.width, 3), jnp.float32)

        def loss(p):
            return ((render_frame(p, static, key) - target) ** 2).mean()

        _JITTED["grad", static] = jax.jit(jax.value_and_grad(loss))
    return _JITTED["grad", static]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device():
    import jax

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"JAX found no GPU (platform {dev.platform!r})")
    card = card_line()
    log(f"card: {card}")
    log(f"jax {jax.__version__}; devices: {len(jax.devices())} x {dev.device_kind}")
    return dev, card


def phase_cli():
    import numpy as np

    from chess2rt_tpu.app import main as app_main
    from chess2rt_tpu.imageio.bmp import load_bmp_file
    from chess2rt_tpu.scene.assets import FLAGSHIP_SCENE

    out = os.path.join(OUT_DIR, "flagship_1920x1080.bmp")
    t0 = time.perf_counter()
    rc = app_main(["--file", str(FLAGSHIP_SCENE), "-o", out, "-q", "--stats"])
    check(rc == 0, f"CLI exit code {rc}")
    rgb = load_bmp_file(out).to_float_rgb()
    log(f"  CLI frame {rgb.shape}, mean {rgb.mean():.4f}, {time.perf_counter() - t0:.1f} s "
        "(compile included)")
    check(rgb.shape == (1080, 1920, 3), f"BMP shape {rgb.shape}")
    check(rgb.mean() > 0.05 and (rgb.max(-1) > 0.1).mean() > 0.5, "CLI frame is black")
    check(np.isfinite(rgb).all(), "CLI frame not finite")


def phase_oracle():
    import numpy as np

    from chess2rt_tpu.models.packed import pack_scene
    from chess2rt_tpu.oracle.renderer import render_scene
    from chess2rt_tpu.scene.assets import load_flagship
    from chess2rt_tpu.utils.color import srgb_u8

    import jax.numpy as jnp

    sc = load_flagship(96, 54)
    ref = srgb_u8(render_scene(sc)).astype(int)
    packed, static = pack_scene(sc, dtype=jnp.float32)
    for name, st in (("kernel", static), ("xla", xla_static(static))):
        dev = srgb_u8(np.asarray(render_fn(st)(packed))).astype(int)
        within1 = float((np.abs(ref - dev) <= 1).mean())
        log(f"  oracle within-1 u8 fraction ({name}, 96x54 AA5): {within1:.5f}")
        check(within1 >= 0.99, f"oracle within-1 {within1} < 0.99 ({name})")


def phase_kernel():
    import numpy as np

    for w, h, aa in ((480, 272, False), (1920, 1080, True)):
        packed, static = flagship(w, h, aa=aa)
        img_k = np.asarray(render_fn(static)(packed))
        img_x = np.asarray(render_fn(xla_static(static))(packed))
        rel, close = frames_close(img_k, img_x)
        log(f"  kernel vs XLA {w}x{h} AA{5 if aa else 1}: rel checksum {rel:.3e}, "
            f"within 2e-3: {close:.5f}")
        check(rel < 5e-4 and close >= 0.99, f"kernel vs XLA at {w}x{h}")
        if w == 480:
            ka = dataclasses.replace(static, aa_enabled=True, aa_adaptive=True)
            xa = dataclasses.replace(xla_static(static), aa_enabled=True, aa_adaptive=True)
            img_ka = np.asarray(render_fn(ka)(packed))
            img_xa = np.asarray(render_fn(xa)(packed))
            rel, close = frames_close(img_ka, img_xa)
            log(f"  adaptive AA kernel vs XLA {w}x{h}: rel checksum {rel:.3e}, "
                f"within 2e-3: {close:.5f}")
            check(rel < 5e-4 and close >= 0.99, "adaptive AA kernel vs XLA")


def phase_grad():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chess2rt_tpu.grad import InverseProblem, fit

    packed, static = flagship(640, 480, aa=False)
    check(static.train_textures, "texel gradients off")
    lv, g = loss_grad_fn(static)(packed)
    leaves = jax.tree.leaves(g)
    finite = bool(np.isfinite(float(lv))) and all(bool(jnp.isfinite(x).all()) for x in leaves)
    gsum = sum(float(jnp.abs(x).sum()) for x in leaves)
    tex = float(jnp.abs(g.bitmap_atlas).sum())
    log(f"  grad step 640x480: loss {float(lv):.6f}, |grad| {gsum:.4e}, |texel grad| {tex:.4e}")
    check(finite and gsum > 0 and tex > 0, "grad step not finite or zero")

    # the optimizer loop at 320x240, one bounce, on the XLA wavefront: the
    # kernel-path gradient is the step above, and each kernel-path grad
    # program takes minutes to compile
    packed, static = flagship(320, 240, aa=False)
    st = dataclasses.replace(xla_static(static), max_trace_depth=1)
    target = jnp.full((st.height, st.width, 3), 0.25, jnp.float32)
    problem = InverseProblem(static=st, target=target,
                             train_fields=("mat_color", "sphere_center", "light_color"),
                             steps=3, learning_rate=1e-2)
    _, losses = fit(packed, problem)
    log(f"  fit 320x240 depth 1 (XLA): 3 Adam steps, losses {[round(float(x), 6) for x in losses]}")
    check(len(losses) == 3 and all(np.isfinite(losses)), "fit losses not finite")


def _load_bump_scene():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bump_scene_src", os.path.join(ROOT, "tests", "test_bump.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._scene()


def phase_bump_gi():
    import numpy as np

    import jax.numpy as jnp

    from chess2rt_tpu.models.packed import pack_scene
    from chess2rt_tpu.scene.assets import load_flagship_gi

    packed, static = pack_scene(_load_bump_scene(), dtype=jnp.float32)
    img_k = np.asarray(render_fn(static)(packed))
    img_x = np.asarray(render_fn(xla_static(static))(packed))
    check(np.isfinite(img_k).all() and np.isfinite(img_x).all(), "bump frame not finite")
    rel, close = frames_close(img_k, img_x)
    log(f"  bump {static.width}x{static.height}: kernel vs XLA rel checksum {rel:.3e}, "
        f"within 2e-3: {close:.5f}, mean {img_x.mean():.4f}")
    check(img_x.mean() > 0.01 and rel < 5e-3, "bump frame")

    packed, static = pack_scene(load_flagship_gi(160, 90, paths=8), dtype=jnp.float32)
    static = dataclasses.replace(static, gi_point_light_direct=True)
    img_k = np.asarray(render_fn(static)(packed))
    img_x = np.asarray(render_fn(xla_static(static))(packed))
    check(np.isfinite(img_k).all() and np.isfinite(img_x).all(), "GI frame not finite")
    rel, close = frames_close(img_k, img_x)
    log(f"  GI 160x90 8 paths/px: kernel vs XLA rel checksum {rel:.3e}, "
        f"within 2e-3: {close:.5f}, mean {img_x.mean():.4f}")
    check(img_x.mean() > 0.01 and rel < 5e-3, "GI frame")


def phase_timing(card):
    """Steady-state medians of the programs the phases above compiled, and
    of the XLA-path grad step and the texel gather."""
    import jax

    from chess2rt_tpu.ops.shade import _quad_atlas_flat, quad_gather_flat

    def measure(name, fn, *args):
        log(fmt_time(name, median_ms(fn, *args), card))

    packed, static = flagship(1920, 1080)
    for name, st in (("kernel", static), ("xla", xla_static(static))):
        measure(f"flagship 1920x1080 depth-5 AA5 frame, {name}", render_fn(st), packed)

    packed, static = flagship(640, 480, aa=False)
    for name, st in (("kernel", static), ("xla", xla_static(static))):
        measure(f"grad step 640x480 texel grads on, {name}", loss_grad_fn(st), packed)

    # the texel gather at the flagship shape: ~2M indices into the quad atlas
    packed, static = flagship(1920, 1080)
    table = _quad_atlas_flat(packed.bitmap_atlas, static.bitmap_sizes)
    idx = jax.random.randint(jax.random.PRNGKey(1), (1920 * 1080,), 0, table.shape[0])
    fwd = jax.jit(quad_gather_flat)
    vjp = jax.jit(jax.grad(lambda t, i: (quad_gather_flat(t, i) ** 2).sum()))
    measure(f"texel gather [{idx.shape[0]}] from [{table.shape[0]}, 12], forward", fwd, table, idx)
    measure("texel gather, forward + scatter-add VJP", vjp, table, idx)


def phase_multi_gpu(card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chess2rt_tpu.parallel import make_mesh, make_sharded_render_fn, make_sharded_value_and_grad

    n = len(jax.devices())
    check(n == 4, f"--multi-gpu needs 4 GPUs, found {n}")
    mesh = make_mesh()

    packed, static = flagship(1920, 1080)
    one = render_fn(static)
    four = jax.jit(lambda p: make_sharded_render_fn(static, mesh)(p, jax.random.PRNGKey(0)))
    img1, img4 = np.asarray(one(packed)), np.asarray(four(packed))
    err = float(np.abs(img1 - img4).max())
    log(f"  sharded flagship 1920x1080 AA5 on {n} cards vs one card: max |diff| {err:.3e}")
    check(np.allclose(img4, img1, atol=1e-5), "sharded frame differs from the one-card frame")
    log(fmt_time("flagship frame, 1 card", median_ms(one, packed), card))
    log(fmt_time(f"flagship frame, {n} cards", median_ms(four, packed), card))

    # gradients of the primary hits (depth 1): a full-depth grad program
    # takes minutes to compile, on each of the two sides
    packed, static = flagship(640, 480, aa=False)
    st = dataclasses.replace(static, max_trace_depth=1)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((st.height, st.width, 3), jnp.float32)
    l1, g1 = loss_grad_fn(st)(packed)
    vg4 = make_sharded_value_and_grad(st, mesh)
    l4, g4 = vg4(packed, target, key)
    check(np.allclose(float(l4), float(l1), rtol=1e-4), f"sharded loss {l4} vs {l1}")
    # rtol 1e-4 against each leaf's largest magnitude: the psum adds the
    # per-shard partial sums in another order than the one-card backward,
    # so leaves near zero differ by rounding at the leaf's own scale
    worst = 0.0
    for a, b in zip(jax.tree.leaves(g4), jax.tree.leaves(g1)):
        a, b = np.asarray(a), np.asarray(b)
        if a.size:
            worst = max(worst, float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30))
    check(worst <= 1e-4, f"sharded gradients differ from the one-card gradients ({worst:.3e})")
    log(f"  sharded 640x480 depth-1 loss {float(l4):.6f} vs one card {float(l1):.6f}; "
        f"worst gradient |diff| / max|grad| {worst:.3e}")
    log(fmt_time("grad step 640x480 depth 1, 1 card", median_ms(loss_grad_fn(st), packed), card))
    log(fmt_time(f"grad step 640x480 depth 1, {n} cards", median_ms(vg4, packed, target, key), card))
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card mesh path and its one-card comparison")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        sys.path.insert(0, ROOT)
        os.makedirs(OUT_DIR, exist_ok=True)
        dev, card = phase_device()
        import jax

        from chess2rt_tpu.utils.cache import enable_compile_cache

        log(f"matmul precision: {jax.config.jax_default_matmul_precision}")
        log(f"compile cache: {enable_compile_cache()}")
        if args.multi_gpu:
            phases = [("multi-gpu", lambda: phase_multi_gpu(card))]
        else:
            phases = [
                ("cli", phase_cli),
                ("oracle", phase_oracle),
                ("kernel", phase_kernel),
                ("bump+gi", phase_bump_gi),
                ("grad", phase_grad),
                ("timing", lambda: phase_timing(card)),
            ]
        count = 1
        for name, fn in phases:
            t0 = time.perf_counter()
            log(f"[{name}]")
            r = fn()
            if name == "multi-gpu":
                count = r
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        print(f"FAILED after {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
        return 1
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
