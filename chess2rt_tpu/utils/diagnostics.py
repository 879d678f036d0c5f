"""Observability & safety sweeps (SURVEY.md §5.1, §5.2, §5.5).

The reference's introspection is a click-to-inspect pixel dump and ad-hoc
wall-clock runs; its race story is language-level purity.  The
equivalents here:

* ``wavefront_occupancy`` — alive-lane fraction per bounce round, the key
  wavefront-efficiency metric (SURVEY.md §7.2 #4).
* ``frame_ray_stats`` — traced-ray counters (camera/shadow/bounce) for
  rays/s reporting.
* ``assert_deterministic`` — same key => bit-identical frame (replaces the
  reference's time-seeded libc rand non-determinism, util/random.d:7-10).
* ``nan_sweep`` — render with jax_debug_nans enabled; any NaN in the
  pipeline raises at the producing op.
* ``profile_trace`` — jax.profiler wrapper producing an XProf/Perfetto
  trace directory.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from ..models.packed import REFLECTION, REFRACTION, ScenePacked, SceneStatic
from ..ops import geometry as G
from ..ops import shade as S
from ..ops.camera import begin_frame, screen_rays
from ..render.pipeline import _whitted_round, render_frame


def _primary_rays(packed: ScenePacked, static: SceneStatic):
    dt = packed.node_matrix.dtype
    ys, xs = jnp.meshgrid(
        jnp.arange(static.height, dtype=dt), jnp.arange(static.width, dtype=dt), indexing="ij"
    )
    frame = begin_frame(packed.camera, static.width / static.height)
    return screen_rays(
        packed.camera, frame, float(static.width), float(static.height),
        xs.reshape(-1), ys.reshape(-1),
    )


def wavefront_occupancy(packed: ScenePacked, static: SceneStatic):
    """Alive-lane fraction entering each wavefront round for the primary
    pixel grid.  [1.0, f1, f2, ...]; length = maxTraceDepth+1 for recursive
    scenes, 1 otherwise."""
    orig, dir = _primary_rays(packed, static)
    recursive = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    rounds = (static.max_trace_depth + 1) if recursive else 1

    @jax.jit
    def run(orig, dir):
        carry = (
            jnp.zeros_like(orig),
            jnp.ones_like(orig),
            jnp.ones(orig.shape[:-1], dtype=bool),
            orig,
            dir,
        )
        fracs = []
        for _ in range(rounds):
            fracs.append(carry[2].mean(dtype=jnp.float32))
            carry = _whitted_round(packed, static, *carry, recursive)
        return jnp.stack(fracs)

    return [float(f) for f in np.asarray(run(orig, dir))]


def frame_ray_stats(packed: ScenePacked, static: SceneStatic, key=None):
    """Exact traced-ray counts for one frame (camera + shadow + bounce)."""
    from ..render.pipeline import render_samples

    key = key if key is not None else jax.random.PRNGKey(0)

    @jax.jit
    def run(packed, key):
        stats = {}
        dt = packed.node_matrix.dtype
        ys, xs = jnp.meshgrid(
            jnp.arange(static.height, dtype=dt), jnp.arange(static.width, dtype=dt), indexing="ij"
        )
        frame = begin_frame(packed.camera, static.width / static.height)
        render_samples(packed, static, frame, xs.reshape(-1), ys.reshape(-1), key, stats=stats)
        return stats

    stats = run(packed, key)
    out = {k: float(v) for k, v in stats.items()}
    out["total"] = sum(out.values())
    if static.aa_enabled:
        out = {k: v * 5 for k, v in out.items()}  # 5 identical-profile AA taps
    return out


def assert_deterministic(packed: ScenePacked, static: SceneStatic, key=None):
    """Render the frame twice with the same key; raise unless bit-identical."""
    key = key if key is not None else jax.random.PRNGKey(0)
    fn = jax.jit(lambda p, k: render_frame(p, static, k))
    a = np.asarray(fn(packed, key))
    b = np.asarray(fn(packed, key))
    if not (a == b).all():
        diff = int((a != b).sum())
        raise AssertionError(f"non-deterministic render: {diff} differing components")
    return a


@contextlib.contextmanager
def debug_nans():
    """Context manager: any NaN produced inside raises immediately."""
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


def nan_sweep(packed: ScenePacked, static: SceneStatic, key=None):
    """Render one frame under jax_debug_nans; returns the frame (and raises
    on any NaN along the way).  NB: masked-lane arithmetic in the pipeline
    is NaN-free by construction (guarded divides), which this verifies."""
    key = key if key is not None else jax.random.PRNGKey(0)
    with debug_nans():
        out = jax.jit(lambda p, k: render_frame(p, static, k))(packed, key)
        jax.block_until_ready(out)
    return np.asarray(out)


def profile_trace(fn, *args, logdir="/tmp/chess2rt_xprof"):
    """Run fn(*args) under the JAX profiler; returns (result, logdir)."""
    with jax.profiler.trace(logdir):
        out = fn(*args)
        jax.block_until_ready(out)
    return out, logdir
