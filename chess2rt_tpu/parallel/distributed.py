"""Multi-process startup (SURVEY.md §5.8).

The reference has no process launcher (single OS process + thread pool).
Here one process drives every card of its host: ``make_mesh()`` over
``jax.devices()`` needs no distributed runtime at all, which is the
single-process path and the default.  Several processes (several hosts,
or one process per card) join through ``jax.distributed.initialize`` with
an explicit coordinator address, process count and process id — nothing
is auto-detected.  After ``initialize_distributed`` the rest of the
framework is unchanged: ``make_mesh()`` sees all global devices, pixel
shards land per process, and the gradient all-reduce is one collective.

    from chess2rt_tpu.parallel import distributed, make_mesh
    distributed.initialize_distributed("host0:1234", num_processes=2, process_id=i)
    mesh = make_mesh()                          # all cards, all processes
    fn = make_sharded_render_fn(static, mesh)
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Join a multi-process runtime when a coordinator is given; without
    one, or when already initialized, this process runs alone and drives
    every local device.  Returns a small info dict."""
    already = getattr(jax.distributed, "is_initialized", lambda: False)()
    if not already and (coordinator_address or num_processes):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_primary() -> bool:
    """True on the host that should write checkpoints / logs."""
    return jax.process_index() == 0
