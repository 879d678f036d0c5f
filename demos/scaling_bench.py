"""Scaling-efficiency harness (BASELINE north star: >=80% rays/s scaling
from 1 chip to N>=2 hosts).

Measures the distributed render — and, with ``--grad``, the full
value_and_grad step (pixel-sharded backward + the psum gradient
all-reduce) — at every device count 1..N on the available platform and
prints per-count rays/s + efficiency vs linear.

With ``--cpu`` it runs on the virtual CPU mesh (methodology validation
only — CPU "devices" share the same socket, so efficiency there measures
harness + collective overhead, not the interconnect).  Without it, it runs
on every visible GPU of the host (one process drives them all), and under
``jax.distributed.initialize`` across hosts.

    python demos/scaling_bench.py --cpu --devices 8 --size 640x480
    python demos/scaling_bench.py --cpu --grad --out SCALING_cpu.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--grad", action="store_true",
                    help="scale the full value_and_grad step (backward + "
                         "psum all-reduce) instead of the forward render")
    ap.add_argument("--fused", action="store_true",
                    help="run the fused Pallas per-shard path (interpret "
                         "mode on the CPU — SLOW, methodology only)")
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args()

    import os

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

    from chess2rt_tpu.models.packed import pack_scene
    from chess2rt_tpu.parallel import (
        make_mesh,
        make_sharded_render_fn,
        make_sharded_value_and_grad,
    )
    from chess2rt_tpu.scene.assets import load_flagship
    from chess2rt_tpu.utils.diagnostics import frame_ray_stats

    w, h = (int(v) for v in args.size.split("x"))
    packed, static = pack_scene(load_flagship(w, h, aa=False), dtype=jnp.float32)
    if args.fused:
        # compiled on the GPU; the interpreter stands in on the CPU
        static = dataclasses.replace(static, use_pallas=True, interpret_pallas=True)

    devices = jax.devices()
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= len(devices)]
    total_rays = frame_ray_stats(packed, static)["total"]
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((h, w, 3), jnp.float32)

    base_rate = None
    rows = []
    for c in counts:
        mesh = make_mesh(devices[:c])
        if args.grad:
            vg = make_sharded_value_and_grad(static, mesh)

            def run(k, vg=vg):
                loss, grads = vg(packed, target, k)
                # touch every leaf so no part of the backward is DCE'd
                return float(loss) + 0.0 * float(
                    sum(jnp.sum(g) for g in jax.tree.leaves(grads))
                )

        else:
            fn = make_sharded_render_fn(static, mesh)

            def run(k, fn=fn):
                return float(jnp.sum(fn(packed, k)))

        run(key)  # compile
        times = []
        for i in range(args.repeats):
            t0 = time.perf_counter()
            run(jax.random.fold_in(key, i))
            times.append(time.perf_counter() - t0)
        rate = total_rays / min(times)
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * c)
        rows.append(
            {
                "devices": c,
                "mode": ("grad" if args.grad else "forward") + ("+fused" if args.fused else ""),
                "rays_per_sec": round(rate, 1),
                "step_ms": round(min(times) * 1000, 2),
                "efficiency": round(eff, 3),
            }
        )
        print(json.dumps(rows[-1]))
    if args.out:
        # MERGE into the artifact so repeated runs (forward, then --grad)
        # accumulate modes instead of clobbering each other — the
        # checked-in SCALING_cpu.json is reproducible by exactly:
        #   python demos/scaling_bench.py --cpu --out SCALING_cpu.json
        #   python demos/scaling_bench.py --cpu --grad --out SCALING_cpu.json
        import os

        payload = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                payload = json.load(f)
        payload.update(
            platform=jax.default_backend(),
            size=args.size,
            note=(
                "virtual CPU mesh methodology run — devices share one socket, "
                "so efficiency bounds harness+collective overhead, not the interconnect"
            )
            if args.cpu
            else "",
        )
        modes = payload.setdefault("modes", {})
        modes[rows[0]["mode"]] = rows
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
