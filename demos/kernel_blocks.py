"""Time the fused round-0 kernel alone for several (rays per program,
warps) choices, and report the registers and spills ptxas gives each.
``ops/pallas_trace.BLOCK`` and ``NUM_WARPS`` come from this sweep.

    python demos/kernel_blocks.py                       # 1920x1080 flagship
    python demos/kernel_blocks.py --configs 128:4,256:8

Needs an NVIDIA GPU; the register counts also need ``ptxas`` from the CUDA
toolkit (PATH or /usr/local/cuda/bin).  The XLA dump it reads them from is
written under build/kernel_blocks/ (git-ignored).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMP = os.path.join(ROOT, "build", "kernel_blocks")


def ptxas_lines(ptx_files):
    """ptxas -v register and spill lines of the fused kernel in ``ptx_files``."""
    ptxas = shutil.which("ptxas") or "/usr/local/cuda/bin/ptxas"
    if not os.path.exists(ptxas):
        return ["ptxas not found: registers not measured"]
    out = []
    for path in ptx_files:
        if "fused_round0" not in open(path).read():
            continue
        r = subprocess.run([ptxas, "-v", "--gpu-name", "sm_90a", path, "-o", os.devnull],
                           capture_output=True, text=True)
        out += [ln.split(":", 1)[-1].strip() for ln in (r.stdout + r.stderr).splitlines()
                if "registers" in ln or "spill" in ln]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--configs", default="128:4,256:8,512:16,256:4",
                    help="comma-separated rays-per-program:warps pairs")
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)

    shutil.rmtree(DUMP, ignore_errors=True)
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={DUMP}"
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chess2rt_tpu.models.packed import pack_scene
    from chess2rt_tpu.ops import pallas_trace as PT
    from chess2rt_tpu.scene.assets import load_flagship

    if jax.devices()[0].platform != "gpu":
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    except OSError as e:
        card = f"nvidia-smi unavailable ({e})"
    w, h = map(int, args.size.split("x"))
    packed, static = pack_scene(load_flagship(w, h), dtype=jnp.float32)
    for cfg in args.configs.split(","):
        block, warps = map(int, cfg.split(":"))
        PT.BLOCK, PT.NUM_WARPS = block, warps
        seen = set(glob.glob(os.path.join(DUMP, "*.ptx")))
        k = PT.build_round0_kernel(static, w, h)
        f = jax.jit(lambda p, k=k: k(p))
        t0 = time.perf_counter()
        f = f.lower(packed).compile()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(f(packed))
        ts = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(packed))
            ts.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(ts, [25, 50, 75])
        regs = "; ".join(ptxas_lines(sorted(set(glob.glob(os.path.join(DUMP, "*.ptx"))) - seen)))
        print(f"round-0 kernel {w}x{h}, {block} rays / {warps} warps: median {med:.3f} ms "
              f"(q1 {q1:.3f}, q3 {q3:.3f}, n={args.repeats}; compile {compile_s:.1f} s) "
              f"[{regs}] [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
