"""Real multi-process ``jax.distributed`` bring-up exercise (SURVEY.md §5.8).

The multi-process story (parallel/distributed.py) is normally validated on
a virtual in-process mesh; this module exercises the ACTUAL process bring-up path on
CPU: N OS processes, a TCP coordinator, ``jax.distributed.initialize``, a
global mesh spanning both processes, and one sharded value_and_grad step
whose (loss, grads) must match the in-process mesh result — the
per-shard-gradient psum makes the math shard-count independent, so any
mesh layout must agree to fp-reduction order.

Two entry points:

* ``python -m chess2rt_tpu.parallel.mp_dryrun --process-id I ...`` — one
  worker process (run by the launcher, one per rank);
* ``run_multiprocess_dryrun(...)`` — spawns the workers with a fresh TCP
  port, waits, and returns process 0's saved (loss, grads) for the caller
  to compare (used by __graft_entry__.dryrun_multichip and
  tests/test_parallel.py).

Reference counterpart: none — the reference is a single OS process with a
thread pool (renderer.d:133-136); multi-process startup is its
replacement (SURVEY.md §5.8).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

def _build(width: int, height: int):
    import jax.numpy as jnp

    from ..models.packed import pack_scene
    from ..scene.assets import flagship_scene_path
    from ..scene.loader import parse_scene_from_file

    sc = parse_scene_from_file(flagship_scene_path())
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.camera.set_frame_size(width, height)
    sc.settings.AAEnabled = False
    return pack_scene(sc, dtype=jnp.float32)


def worker_main(argv=None) -> None:
    """One rank of the multi-process dryrun: bring up jax.distributed,
    build the global mesh, run ONE sharded grad step, rank 0 saves the
    result."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh2d", action="store_true",
                    help="build the 2-D (hosts x chips) mesh: the host axis "
                         "spans the OS processes (the cross-process stage of the psum "
                         "decomposition), the chip axis is process-local")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")  # the dryrun is a CPU exercise

    from .distributed import initialize_distributed
    from .mesh import make_mesh, make_mesh_2d, make_sharded_value_and_grad

    info = initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert info["process_count"] == args.num_processes, info
    assert info["global_devices"] >= args.num_processes, info

    import jax.numpy as jnp
    import numpy as np

    packed, static = _build(args.width, args.height)
    if args.mesh2d:
        # (hosts, chips): jax.devices() orders by process, so reshape rows
        # are per-process device groups — the "host" psum stage crosses
        # REAL process boundaries, "chip" stays process-local
        mesh = make_mesh_2d(hosts=args.num_processes)
        assert mesh.devices.shape[0] == args.num_processes, mesh.devices.shape
    else:
        mesh = make_mesh()  # global: spans every process's devices
    vg = make_sharded_value_and_grad(static, mesh)
    target = jnp.zeros((static.height, static.width, 3), dtype=jnp.float32)
    loss, grads = vg(packed, target, jax.random.PRNGKey(0))

    if jax.process_index() == 0:
        leaves = jax.tree.leaves(grads)
        np.savez(
            args.out,
            loss=np.asarray(loss),
            n_leaves=len(leaves),
            **{f"g{i}": np.asarray(l) for i, l in enumerate(leaves)},
        )
    # all ranks block until rank 0 has written: sync_global_devices is a
    # REAL cross-process barrier (an all-reduce over every process's
    # devices) — jax.effects_barrier() is process-local and would let
    # other ranks exit (and collectively tear down the coordinator) while
    # rank 0 is mid-save on a slow filesystem
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("mp_dryrun_save_done")


def run_multiprocess_dryrun(num_processes: int = 2, width: int = 17, height: int = 3,
                            timeout: int = 600, devices_per_process: int = 1,
                            mesh2d: bool = False):
    """Spawn ``num_processes`` worker ranks with a TCP coordinator on a
    fresh port; returns (loss: float, grad_leaves: list[np.ndarray]) from
    rank 0.  Raises on any rank failure (stderr attached).

    ``devices_per_process`` > 1 + ``mesh2d`` runs the (hosts x chips) 2-D
    mesh across REAL process boundaries: the gradient all-reduce
    decomposes into a process-local stage and a cross-process stage
    (SURVEY.md §5.8)."""
    import numpy as np

    with socket.socket() as s:  # reserve a free port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"

    out = os.path.join(tempfile.mkdtemp(prefix="c2rt_mp_"), "rank0.npz")
    env = dict(os.environ)
    # CPU devices per rank: inherit the environment, override the count
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices_per_process}"
    procs = []
    for rank in range(num_processes):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    "chess2rt_tpu.parallel.mp_dryrun",
                    "--coordinator",
                    coordinator,
                    "--num-processes",
                    str(num_processes),
                    "--process-id",
                    str(rank),
                    "--width",
                    str(width),
                    "--height",
                    str(height),
                    "--out",
                    out,
                ]
                + (["--mesh2d"] if mesh2d else []),
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    errs = []
    for rank, pr in enumerate(procs):
        try:
            _, stderr = pr.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
            raise RuntimeError(f"mp_dryrun rank {rank} timed out after {timeout}s")
        if pr.returncode != 0:
            errs.append(f"rank {rank} rc={pr.returncode}:\n{stderr[-2000:]}")
    if errs:
        raise RuntimeError("mp_dryrun worker failure:\n" + "\n".join(errs))

    data = np.load(out)
    leaves = [data[f"g{i}"] for i in range(int(data["n_leaves"]))]
    return float(data["loss"]), leaves


if __name__ == "__main__":
    worker_main()
