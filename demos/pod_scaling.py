"""Multi-device scaling recipe — fills BASELINE.md's "scaling efficiency,
1 chip -> N devices" row with ZERO additional code (SURVEY.md §5.8).

ONE command; on one host it drives every visible GPU from one process,
across hosts it runs identically on every host:

    python demos/pod_scaling.py --out SCALING_gpu.json

What it does:
  1. joins a multi-process runtime when --coordinator/--nprocs/--pid are
     given (``chess2rt_tpu.parallel.distributed.initialize_distributed``);
     a single process needs none,
  2. builds the flagship bench scene (scenes/flagship.sdl, 1080p, depth 5,
     AA 5 — ``bench.build``) and asks for the fused kernel (compiled on
     the GPU; the CPU rehearsal runs the XLA wavefront),
  3. measures the sharded forward frame (``make_sharded_render_fn``)
     and the full sharded value_and_grad step
     (``make_sharded_value_and_grad`` — per-shard backward + psum
     all-reduce) at global device counts 1, 2, 4, ... N,
  4. prints rays/s + efficiency-vs-1-chip per count and, on the primary
     host, writes the JSON artifact whose rows are exactly what
     BASELINE.md:46 wants (rays/s and grad-step at N chips/hosts,
     efficiency vs 1 chip).

Every process executes every device-count computation (multi-controller
JAX requires it); counts smaller than the total use the first ``c`` global
devices and the remaining hosts just participate in dispatch.

Rehearsal without GPUs (methodology validation; run by the test suite):

    python demos/pod_scaling.py --cpu --devices 8 --size 192x108 --repeats 1

Timing notes: each point times REPEATS calls and takes the min; inputs
are key-distinct per call so no retrace/LICM hazard applies (each call is
one program execution).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--devices", type=int, default=None,
                    help="with --cpu: size of the virtual mesh (default 8)")
    ap.add_argument("--cpu", action="store_true",
                    help="virtual-CPU-mesh rehearsal (methodology only)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--coordinator", default=None, help="coordinator_address for manual bring-up")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--out", default=None, help="primary host writes the JSON artifact here")
    args = ap.parse_args()

    if args.cpu:
        n = args.devices or 8
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={n}"
        ).strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    import jax.numpy as jnp

    import bench
    from chess2rt_tpu.parallel import (
        distributed,
        make_mesh,
        make_sharded_render_fn,
        make_sharded_value_and_grad,
    )
    from chess2rt_tpu.utils.diagnostics import frame_ray_stats

    info = distributed.initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.nprocs,
        process_id=args.pid,
    )
    if distributed.is_primary():
        print(f"# runtime: {info}", file=sys.stderr)

    w, h = (int(v) for v in args.size.split("x"))
    packed, static = bench.build(w, h)
    static = dataclasses.replace(
        static,
        fast_forward=True,
        bounce_capacity=max(w * h // 16, 8192),
        bounce_mode="block",
    )
    static_grad = dataclasses.replace(static, aa_enabled=False, fast_forward=False)

    devices = jax.devices()
    counts = [c for c in (1, 2, 4, 8, 16, 32, 64, 128, 256) if c <= len(devices)]
    if counts[-1] != len(devices):
        counts.append(len(devices))
    total_rays = frame_ray_stats(packed, static)["total"]
    grad_rays = frame_ray_stats(packed, static_grad)["total"]
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((h, w, 3), jnp.float32)

    rows = []
    base = {}
    for c in counts:
        mesh = make_mesh(devices[:c])
        render = make_sharded_render_fn(static, mesh)
        vg = make_sharded_value_and_grad(static_grad, mesh)

        def run_fwd(k):
            return float(jnp.sum(render(packed, k)))

        def run_grad(k):
            loss, grads = vg(packed, target, k)
            # touch every leaf so no part of the backward can be DCE'd
            return float(loss) + 0.0 * float(sum(jnp.sum(g) for g in jax.tree.leaves(grads)))

        for mode, run, rays in (("forward", run_fwd, total_rays), ("grad", run_grad, grad_rays)):
            assert abs(run(key)) >= 0.0  # compile + sanity (forward checksum > 0)
            times = []
            for i in range(args.repeats):
                t0 = time.perf_counter()
                run(jax.random.fold_in(key, i + 1))
                times.append(time.perf_counter() - t0)
            dt = min(times)
            rate = rays / dt
            base.setdefault(mode, rate)
            row = {
                "devices": c,
                "mode": mode,
                "rays_per_sec": round(rate, 1),
                "ms": round(dt * 1000, 2),
                "efficiency_vs_1chip": round(rate / (base[mode] * c), 3),
            }
            rows.append(row)
            if distributed.is_primary():
                print(json.dumps(row))

    if distributed.is_primary():
        nmax = counts[-1]
        f = next(r for r in reversed(rows) if r["mode"] == "forward")
        g = next(r for r in reversed(rows) if r["mode"] == "grad")
        print(
            f"# BASELINE.md:46 row -> forward {f['rays_per_sec']/1e6:.1f}M rays/s "
            f"@ {nmax} devices (eff {f['efficiency_vs_1chip']}); grad step "
            f"{g['ms']} ms (eff {g['efficiency_vs_1chip']})",
            file=sys.stderr,
        )
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(
                    {
                        "platform": jax.default_backend(),
                        "size": args.size,
                        "processes": info["process_count"],
                        "global_devices": info["global_devices"],
                        "note": (
                            "virtual CPU mesh rehearsal — efficiency bounds harness/"
                            "collective overhead, not the interconnect" if args.cpu else ""
                        ),
                        "rows": rows,
                    },
                    fh,
                    indent=1,
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
