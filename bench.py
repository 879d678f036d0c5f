"""Benchmark: rays/s on the flagship scene (BASELINE.md north star).

Config: scenes/flagship.sdl (CSG + 2 bitmap textures + Phong + transforms
+ a mirror sphere) at 1920x1080 with maxTraceDepth=5 — the BASELINE
"recursive reflection, depth 5" configuration — AA enabled (the engine
default, renderer.d:183-186: every pixel gets 5 samples).

Counted rays (matching how BASELINE.md derives the reference's ~250k
total rays/s from perf-results.md): camera/AA sample rays + shadow rays
(one per lit shading point per light) + reflection continuation rays.
Counts are measured exactly by an instrumented (untimed) pass.

Prints ONE JSON line:
    {"metric": "rays_per_sec_chip", "value": ..., "unit": "rays/s",
     "vs_baseline": ...}
vs_baseline is against the reference's derived ~250k total rays/s
(BASELINE.md: 640x480 incl. shadow rays / 2.417 s on 1 CPU core).
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REFERENCE_TOTAL_RAYS_PER_SEC = 250_000.0  # BASELINE.md derived row

WIDTH, HEIGHT = 1920, 1080
REPEATS = 3


def build(width=WIDTH, height=HEIGHT):
    """The flagship scene (scenes/flagship.sdl: CSG, two bitmap textures,
    Phong, transforms and a mirror sphere; depth 5, AA on), packed f32."""
    from chess2rt_tpu.models.packed import pack_scene
    from chess2rt_tpu.scene.assets import load_flagship

    return pack_scene(load_flagship(width, height), dtype=jnp.float32)


def build_gi(width, height, paths=40):
    """The GI configuration: the flagship scene's path-tracing twin
    (scene/assets.load_flagship_gi) with the NEE extension
    (gi_point_light_direct), depth 5."""
    import dataclasses

    from chess2rt_tpu.models.packed import pack_scene
    from chess2rt_tpu.scene.assets import load_flagship_gi

    packed, static = pack_scene(load_flagship_gi(width, height, paths), dtype=jnp.float32)
    return packed, dataclasses.replace(static, gi_point_light_direct=True)


def main_grad_gi(w=640, h=480, steps_per_call=4, paths=40):
    """GI grad benchmark: a full value_and_grad
    step through the PATH-TRACED pipeline (NEE on, depth 5, 40 paths/px)
    on the fused want_hit GI renderer.  Key-jittered camera per step (the
    GI pipeline consumes its key anyway, so LICM can't hoist the body).

    Prints one JSON line: {"metric": "gi_grad_paths_per_sec", ...}."""
    import dataclasses

    from chess2rt_tpu.render.pipeline import render_frame

    packed, static = build_gi(w, h, paths)
    # flagship-resolution steps stack paths x bounce-round AD residuals
    # without path remat — see models/packed.py
    static = dataclasses.replace(
        static, gi_remat_paths=(w * h) >= (1 << 20)
    )
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((h, w, 3), dtype=jnp.float32)

    def loss(p, k):
        return ((render_frame(p, static, k) - target) ** 2).mean()

    STEPS_PER_CALL = steps_per_call

    def many(p, keys):
        def body(acc, k):
            jit_pos = (jax.random.uniform(k, (3,), jnp.float32) - 0.5) * 1e-4
            p2 = dataclasses.replace(
                p, camera=dataclasses.replace(p.camera, pos=p.camera.pos + jit_pos)
            )
            l, g = jax.value_and_grad(loss)(p2, k)
            gsum = sum(jnp.sum(x) for x in jax.tree.leaves(g))
            return acc + l + 1e-30 * gsum, None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), keys)
        return acc

    vg = jax.jit(many)
    keys = jax.random.split(key, STEPS_PER_CALL)
    l0 = vg(packed, keys)
    assert np.isfinite(float(l0))

    times = []
    for i in range(REPEATS):
        t0 = time.perf_counter()
        float(vg(packed, jax.random.split(jax.random.fold_in(key, i), STEPS_PER_CALL)))
        times.append(time.perf_counter() - t0)
    dt = min(times) / STEPS_PER_CALL

    camera_paths = w * h * paths
    print(
        json.dumps(
            {
                "metric": "gi_grad_paths_per_sec",
                "value": round(camera_paths / dt, 1),
                "unit": "camera paths/s (fwd+bwd, NEE, depth 5)",
                "vs_baseline": None,
            }
        )
    )
    print(
        f"# GI fwd+bwd step {dt*1000:.1f} ms at {w}x{h}, {paths} paths/px "
        f"({camera_paths/1e6:.1f}M camera paths/frame)",
        file=sys.stderr,
    )


def main_grad(w=640, h=480, steps_per_call=8):
    """Secondary metric (BASELINE.md): grad-rays/s — traced rays per second
    for a full value_and_grad step (forward + backward through the whole
    differentiable pipeline) on the flagship scene, AA off.  Default
    640x480; `--grad --size 1920x1080` measures the flagship-resolution
    step, texel gradients on either way.

    Prints one JSON line: {"metric": "grad_rays_per_sec", ...}."""
    import dataclasses

    from chess2rt_tpu.render.pipeline import render_frame
    from chess2rt_tpu.utils.diagnostics import frame_ray_stats

    packed, static = build(w, h)
    # compaction is differentiable (cond/gather/scatter all have VJPs);
    # dead bounce rounds are skipped by the differentiable lax.cond in
    # _run_rounds.
    # on the GPU the forward runs the fused kernel and the backward runs
    # the pinned-discrete XLA re-shade (ops/pallas_grad.py custom VJP) —
    # no shadow scans anywhere in the grad step.
    static = dataclasses.replace(
        static,
        aa_enabled=False,
        bounce_capacity=w * h // 16,
        bounce_mode="block",
    )
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((h, w, 3), dtype=jnp.float32)

    def loss(p, k):
        return ((render_frame(p, static, k) - target) ** 2).mean()

    # STEPS_PER_CALL fwd+bwd steps inside one program — every step is a
    # REAL, distinct step thanks to the key-jittered camera below.  Every
    # grad leaf feeds the checksum so no part of the backward can be DCE'd.
    STEPS_PER_CALL = steps_per_call

    def many(p, keys):
        def body(acc, k):
            # key-jitter the camera so the scan body is NOT loop-invariant
            # (same LICM hazard as main(): the deterministic render ignores
            # the RNG key, and a hoisted body times one step as N)
            jit_pos = (jax.random.uniform(k, (3,), jnp.float32) - 0.5) * 1e-4
            p2 = dataclasses.replace(
                p, camera=dataclasses.replace(p.camera, pos=p.camera.pos + jit_pos)
            )
            l, g = jax.value_and_grad(loss)(p2, k)
            gsum = sum(jnp.sum(x) for x in jax.tree.leaves(g))
            # tiny nonzero weight: keeps every grad leaf live (0.0 * gsum
            # could be algebraically simplified away) without perturbing
            # the finiteness check
            return acc + l + 1e-30 * gsum, None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), keys)
        return acc

    vg = jax.jit(many)
    keys = jax.random.split(key, STEPS_PER_CALL)
    l0 = vg(packed, keys)  # compile
    assert np.isfinite(float(l0))

    times = []
    for i in range(REPEATS):
        t0 = time.perf_counter()
        float(vg(packed, jax.random.split(jax.random.fold_in(key, i), STEPS_PER_CALL)))
        times.append(time.perf_counter() - t0)
    dt = min(times) / STEPS_PER_CALL

    stats = frame_ray_stats(packed, static, key)
    total = stats["total"]
    print(
        json.dumps(
            {
                "metric": "grad_rays_per_sec",
                "value": round(total / dt, 1),
                "unit": "rays/s (fwd+bwd)",
                "vs_baseline": None,
            }
        )
    )
    print(f"# fwd+bwd step {dt*1000:.1f} ms, {total/1e6:.2f}M rays/frame", file=sys.stderr)


def main_sharded():
    """The SHARDED fused renderer on a 1-device mesh (the mesh path must
    carry the fused frame rate of the single-device flagship).  Same
    flagship config and key-jittered amortization as main().

    Prints one JSON line: {"metric": "sharded_frame_ms", ...}."""
    import dataclasses

    from chess2rt_tpu.parallel import make_mesh, make_sharded_render_fn

    packed, static = build()
    static = dataclasses.replace(
        static,
        fast_forward=True,
        bounce_capacity=2073600 // 16,
        bounce_mode="block",
    )
    mesh = make_mesh(jax.devices()[:1])
    render = make_sharded_render_fn(static, mesh)

    FRAMES_PER_CALL = 4

    def many(p, keys):
        def body(acc, k):
            # key-jittered camera: see main() — LICM would hoist a
            # loop-invariant body and inflate the amortized number
            jit_pos = (jax.random.uniform(k, (3,), jnp.float32) - 0.5) * 1e-4
            p2 = dataclasses.replace(
                p, camera=dataclasses.replace(p.camera, pos=p.camera.pos + jit_pos)
            )
            return acc + render(p2, k).sum(), None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), keys)
        return acc

    fn = jax.jit(many)
    key = jax.random.PRNGKey(0)
    checksum = float(fn(packed, jax.random.split(key, FRAMES_PER_CALL)))
    assert np.isfinite(checksum) and checksum > 0, checksum

    times = []
    for i in range(REPEATS):
        t0 = time.perf_counter()
        float(fn(packed, jax.random.split(jax.random.fold_in(key, i), FRAMES_PER_CALL)))
        times.append(time.perf_counter() - t0)
    dt = min(times) / FRAMES_PER_CALL
    print(
        json.dumps(
            {
                "metric": "sharded_frame_ms",
                "value": round(dt * 1000, 2),
                "unit": "ms/frame (1-device mesh, fused)",
                "vs_baseline": None,
            }
        )
    )
    print(f"# sharded fused flagship {WIDTH}x{HEIGHT}: {dt*1000:.1f} ms/frame", file=sys.stderr)


def main():
    import dataclasses

    packed, static = build()
    # the fused primary kernel covers the full flagship scene (CSG +
    # bitmaps + transforms + mirror); bounce rounds re-enter the ray-input
    # kernel on a BLOCK-compacted buffer (bounce_mode="block"): whole
    # 128-lane blocks with any live lane are gathered into ~n/12 block
    # slots, so the round-1 combine runs at a fraction of the frame width
    # while the compaction bookkeeping stays small (sort over n/128 block
    # keys, slab gathers/adds).
    static = dataclasses.replace(
        static,
        fast_forward=True,
        bounce_capacity=2073600 // 16,
        bounce_mode="block",
    )
    from chess2rt_tpu.render.pipeline import AA_KERNEL, begin_frame, render_frame, render_samples

    # The timed function reduces the frame to a checksum on-device: timing
    # ends when the scalar arrives on the host, which guarantees the full
    # frame was computed.  FRAMES_PER_CALL frames run inside ONE program
    # (lax.scan over keys), so the measurement is per-frame throughput.
    FRAMES_PER_CALL = 4

    def many(p, keys):
        def body(acc, k):
            # Fold the key into the CAMERA, not just the (unused-on-this-
            # deterministic-path) RNG arg: a loop-invariant scan body gets
            # hoisted by XLA's while-loop LICM, so a constant-scene scan
            # would time ONE frame + N-1 adds and report an N-x-inflated
            # throughput.  The ~1e-4-unit camera jitter is visually null
            # but forces every iteration to render.
            jit_pos = (jax.random.uniform(k, (3,), jnp.float32) - 0.5) * 1e-4
            p2 = dataclasses.replace(
                p, camera=dataclasses.replace(p.camera, pos=p.camera.pos + jit_pos)
            )
            return acc + render_frame(p2, static, k).sum(), None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), keys)
        return acc

    fn = jax.jit(many)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, FRAMES_PER_CALL)

    checksum = float(fn(packed, keys))  # warmup / compile
    assert np.isfinite(checksum) and checksum > 0, checksum

    times = []
    for i in range(REPEATS):
        t0 = time.perf_counter()
        float(fn(packed, jax.random.split(jax.random.fold_in(key, i), FRAMES_PER_CALL)))
        times.append(time.perf_counter() - t0)
    dt = min(times) / FRAMES_PER_CALL

    # Exact ray counts via an instrumented (unrolled, untimed) pass at 1/4
    # linear scale, base AA tap only: hit/shadow/bounce fractions are
    # resolution- and sub-pixel-offset-independent to well under a percent,
    # so counts scale by the pixel ratio x the 5 AA taps.
    cw, ch = WIDTH // 4, HEIGHT // 4
    packed_c, static_c = build(cw, ch)

    def counted(p, k):
        stats = {}
        frame = begin_frame(p.camera, static_c.width / static_c.height)
        dtp = p.node_matrix.dtype
        ys, xs = jnp.meshgrid(
            jnp.arange(static_c.height, dtype=dtp), jnp.arange(static_c.width, dtype=dtp), indexing="ij"
        )
        render_samples(p, static_c, frame, xs.reshape(-1), ys.reshape(-1), k, stats=stats)
        return stats

    stats = jax.jit(counted)(packed_c, key)
    aa_taps = 5.0 if static.aa_enabled else 1.0
    scale = (WIDTH * HEIGHT) / (cw * ch) * aa_taps
    stats = {k: float(v) * scale for k, v in stats.items()}
    total_rays = stats.get("camera", 0.0) + stats.get("shadow", 0.0) + stats.get("bounce", 0.0)

    rays_per_sec = total_rays / dt
    dev = jax.devices()[0]
    result = {
        "metric": "rays_per_sec_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / REFERENCE_TOTAL_RAYS_PER_SEC, 2),
    }
    print(json.dumps(result))
    print(
        f"# {dev.platform}:{dev.device_kind} {WIDTH}x{HEIGHT} depth-{static.max_trace_depth} "
        f"AA5: frame {dt*1000:.1f} ms, {total_rays/1e6:.1f}M rays "
        f"(camera {stats.get('camera', 0.0)/1e6:.1f}M, shadow {stats.get('shadow', 0.0)/1e6:.1f}M, "
        f"bounce {stats.get('bounce', 0.0)/1e6:.1f}M)",
        file=sys.stderr,
    )


def main_verify_counts():
    """One-time validation of the 1/4-scale count extrapolation: run the instrumented pass at BOTH 1/4 scale and full
    1080p and report the relative delta of the extrapolated vs true
    counts.  Slow (full-res unrolled stats pass) — not part of the normal
    bench."""
    from chess2rt_tpu.render.pipeline import begin_frame, render_samples

    def counted(width, height):
        packed_c, static_c = build(width, height)

        def fn(p, k):
            stats = {}
            frame = begin_frame(p.camera, static_c.width / static_c.height)
            dtp = p.node_matrix.dtype
            ys, xs = jnp.meshgrid(
                jnp.arange(static_c.height, dtype=dtp),
                jnp.arange(static_c.width, dtype=dtp),
                indexing="ij",
            )
            render_samples(p, static_c, frame, xs.reshape(-1), ys.reshape(-1), k, stats=stats)
            return stats

        return {k: float(v) for k, v in jax.jit(fn)(packed_c, jax.random.PRNGKey(0)).items()}

    quarter = counted(WIDTH // 4, HEIGHT // 4)
    full = counted(WIDTH, HEIGHT)
    scale = 16.0
    report = {}
    for k in sorted(full):
        extrap = quarter.get(k, 0.0) * scale
        delta = abs(extrap - full[k]) / max(full[k], 1.0)
        report[k] = round(delta, 5)
        print(f"# {k}: full {full[k]:.0f} vs extrapolated {extrap:.0f} "
              f"(delta {delta*100:.3f}%)", file=sys.stderr)
    total_full = sum(full.values())
    total_ex = sum(quarter.values()) * scale
    print(json.dumps({
        "metric": "count_extrapolation_delta",
        "value": round(abs(total_ex - total_full) / total_full, 6),
        "unit": "relative",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    from chess2rt_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if "--grad" in sys.argv:
        w, h = 640, 480
        if "--size" in sys.argv:
            w, h = map(int, sys.argv[sys.argv.index("--size") + 1].split("x"))
        if "--gi" in sys.argv:
            steps = 4 if w * h <= 640 * 480 else 1
            if "--steps" in sys.argv:
                steps = int(sys.argv[sys.argv.index("--steps") + 1])
            main_grad_gi(w, h, steps)
        else:
            steps = 8 if w * h <= 640 * 480 else 4
            if "--steps" in sys.argv:
                steps = int(sys.argv[sys.argv.index("--steps") + 1])
            main_grad(w, h, steps)
    elif "--sharded" in sys.argv:
        main_sharded()
    elif "--verify-counts" in sys.argv:
        main_verify_counts()
    else:
        main()
