"""Which path renders a frame: one predicate for every caller.

* ``"compiled"``: the fused Pallas kernel (ops/pallas_trace.py) compiled
  for the GPU through Triton.  A kernel that fails to lower or compile
  raises; nothing falls back to the interpreter or to XLA.
* ``"interpret"``: the same kernel in the Pallas interpreter — CPU only,
  and only when the scene asks for it (``interpret_pallas=True``, tests).
* ``"xla"``: the XLA wavefront (render/pipeline.py).

Scenes the kernel does not cover still render through the XLA wavefront;
that is coverage, not a fallback, and :func:`note_xla_coverage` logs it
once per reason.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp

XLA, COMPILED, INTERPRET = "xla", "compiled", "interpret"

_log = logging.getLogger(__name__)
_noted: set = set()


def kernel_mode(static, dtype=jnp.float32) -> str:
    """The render path for a scene structure on the current backend."""
    if not static.use_pallas or jnp.dtype(dtype) != jnp.float32:
        return XLA  # the kernel is f32-only; f64 parity runs stay XLA
    if jax.default_backend() == "gpu":
        return COMPILED
    if static.interpret_pallas:
        return INTERPRET
    return XLA


def note_xla_coverage(reason: str) -> None:
    """Log, once per reason, that a scene goes to the XLA wavefront because
    the fused kernel does not cover it."""
    if reason not in _noted:
        _noted.add(reason)
        _log.info("fused kernel does not cover this scene (%s): XLA wavefront", reason)
