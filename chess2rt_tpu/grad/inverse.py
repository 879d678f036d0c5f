"""Inverse rendering: recover scene parameters from a target image.

The differentiable-rendering north star (BASELINE config #5: "recover
material colors + sphere positions from a target image by Adam on pixel
L2").  Gradients flow through the whole wavefront pipeline to every
ScenePacked leaf; discrete selections (closest-hit winner, shadow masks,
checker parity) are piecewise-constant so their gradients are zero — the
standard differentiable-rendering compromise (SURVEY.md §7.0): optimize
parameters that keep the discrete structure locally fixed (colors, light
power, texture params) exactly, and geometry (positions, radii) through
the smooth shading terms.

Works single-chip or over a device mesh (pixel-sharded forward, gradient
all-reduce — parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import optax

from ..models.packed import ScenePacked, SceneStatic
from ..render.pipeline import render_frame
from .checkpoint import load_pytree, save_pytree


@dataclass
class InverseProblem:
    """Configuration for a fit() run."""

    static: SceneStatic
    target: jnp.ndarray  # [H, W, 3] float
    train_fields: Sequence[str] = ("mat_color", "sphere_center")  # ScenePacked field names
    learning_rate: float = 1e-2
    steps: int = 200
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 50
    mesh: object = None  # jax.sharding.Mesh for distributed fitting
    # True (default): fold the RNG key per step — proper SGD on the
    # expected loss for stochastic pipelines (DoF/GI), converging to the
    # MC noise floor.  False: the SAME key every step — the MC render
    # becomes a smooth deterministic function of the parameters
    # (correlated-sample inverse rendering), so GI fits recover exactly.
    resample_keys: bool = True
    # Per-field multipliers applied to the Adam UPDATES (not the grads —
    # Adam normalizes grad magnitude away, so scaling grads is a no-op).
    # Effective per-field step size = learning_rate * scale.  Needed when
    # trained fields live on wildly different scales: colors are O(1) but
    # light_power is O(5e4) (lecture4.sdl:24), so a pixel-scale lr would
    # move it ~0.04/step — frozen for any practical step count.
    # Keys are train_fields names (camera.* supported).
    update_scales: Optional[dict] = None
    # Final-lr fraction for an exponential decay over `steps`.  1.0 (the
    # default) = constant lr.  With resample_keys the loss is stochastic
    # (fresh MC noise every step), so constant-lr Adam random-walks around
    # the optimum at a radius set by lr; decaying to ~5% converges through
    # the noise floor (standard Robbins-Monro step-size schedule).
    lr_decay_to: float = 1.0


def _mask_grads(grads: ScenePacked, train_fields) -> ScenePacked:
    """Zero gradients of every field not being optimized (incl. camera)."""
    updates = {}
    for f in dataclasses.fields(grads):
        if f.name == "camera":
            trained = [n.split(".", 1)[1] for n in train_fields if n.startswith("camera.")]
            cam = grads.camera
            cam_updates = {
                cf.name: (getattr(cam, cf.name) if cf.name in trained else jax.tree.map(jnp.zeros_like, getattr(cam, cf.name)))
                for cf in dataclasses.fields(cam)
            }
            updates[f.name] = dataclasses.replace(cam, **cam_updates)
        elif f.name not in train_fields:
            updates[f.name] = jax.tree.map(jnp.zeros_like, getattr(grads, f.name))
    return dataclasses.replace(grads, **updates)


def fit(
    packed: ScenePacked,
    problem: InverseProblem,
    key=None,
    on_step: Optional[Callable[[int, float], None]] = None,
):
    """Adam on pixel L2.  Returns (packed_optimized, losses)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    static, target = problem.static, problem.target

    if "bitmap_atlas" not in problem.train_fields and static.train_textures:
        # texel cotangents are an expensive part of the backward (a
        # scatter-add per ray); when the atlas isn't being optimized the
        # grads would be masked to zero anyway — stop them at the source
        static = dataclasses.replace(static, train_textures=False)

    if problem.mesh is not None:
        from ..parallel.mesh import make_sharded_value_and_grad

        vg = make_sharded_value_and_grad(static, problem.mesh)

        def value_and_grad(p, k):
            return vg(p, target, k)

    else:

        def loss_fn(p, k):
            img = render_frame(p, static, k)
            return ((img - target) ** 2).mean()

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn))

    if problem.lr_decay_to != 1.0:
        sched = optax.exponential_decay(
            problem.learning_rate, transition_steps=max(problem.steps, 1),
            decay_rate=problem.lr_decay_to,
        )
        opt = optax.adam(sched)
    else:
        opt = optax.adam(problem.learning_rate)
    opt_state = opt.init(packed)
    start = 0

    if problem.checkpoint_path:
        import os

        if os.path.exists(problem.checkpoint_path):
            (packed, opt_state), start = load_pytree(problem.checkpoint_path, (packed, opt_state))

    scales = dict(problem.update_scales or {})

    def _scale_updates(updates: ScenePacked) -> ScenePacked:
        reps = {}
        cam_scales = {n.split(".", 1)[1]: s for n, s in scales.items() if n.startswith("camera.")}
        for name, s in scales.items():
            if not name.startswith("camera."):
                reps[name] = jax.tree.map(lambda u: u * s, getattr(updates, name))
        if cam_scales:
            cam = updates.camera
            reps["camera"] = dataclasses.replace(
                cam,
                **{n: jax.tree.map(lambda u: u * s, getattr(cam, n)) for n, s in cam_scales.items()},
            )
        return dataclasses.replace(updates, **reps) if reps else updates

    @jax.jit
    def step(p, opt_state, k):
        loss, grads = value_and_grad(p, k)
        grads = _mask_grads(grads, tuple(problem.train_fields))
        updates, opt_state = opt.update(grads, opt_state, p)
        updates = _scale_updates(updates)
        return optax.apply_updates(p, updates), opt_state, loss

    losses = []
    for i in range(start, problem.steps):
        step_key = jax.random.fold_in(key, i) if problem.resample_keys else key
        packed, opt_state, loss = step(packed, opt_state, step_key)
        losses.append(float(loss))
        if on_step:
            on_step(i, losses[-1])
        if problem.checkpoint_path and (i + 1) % problem.checkpoint_every == 0:
            save_pytree(problem.checkpoint_path, (packed, opt_state), step=i + 1)

    return packed, losses
