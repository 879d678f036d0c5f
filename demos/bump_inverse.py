"""Inverse rendering THROUGH the bump extension: recover the BumpTexture
strength and a surface albedo from a target image, on hardware, via the
bump hybrid's custom VJP (ops/pallas_grad.build_bump_round0 — the fast
kernel-record forward, the tangent-carrying leaf-pinned reshade backward).

Scene: the bump coverage scene (plane, sphere, scaled cube, CSG diff; the
same as tests/test_bump.py's) with the CSG node left un-bumped, so the hybrid takes its FAST forward (_fast_bump_ok) — the
fit exercises exactly the production bump path.  The demo perturbs
``bump_strength`` (x0.3) and the shared Lambert albedo (x0.6), recovers
both with Adam on pixel L2, and finishes with an on-hardware central-
difference check on the strength scale (strength enters the perturbed
normal linearly and the texel picks don't depend on it, so with a fixed
key the loss is a smooth deterministic function of it).

    python demos/bump_inverse.py --cpu     # quick CPU run
    python demos/bump_inverse.py           # GPU (fused bump hybrid)

Exits nonzero unless both parameters recover.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from chess2rt_tpu.grad import InverseProblem, fit  # noqa: E402
from chess2rt_tpu.models import types as T  # noqa: E402
from chess2rt_tpu.models.packed import pack_scene  # noqa: E402
from chess2rt_tpu.render.pipeline import render_frame  # noqa: E402


def _heightmap():
    hh, ww = 32, 32
    yy, xx = np.mgrid[0:hh, 0:ww]
    height = (0.5 + 0.5 * np.sin(xx * 0.25) * np.cos(yy * 0.2)).astype(np.float32)
    return np.repeat(height[..., None], 3, axis=-1)


def build(width, height, bump=True, csg_bump=True):
    """Plane + sphere + scaled cube + CSG diff, every tangent case, all
    sharing one Lambert albedo and one BumpTexture."""
    sc = T.Scene()
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.settings.AAEnabled = True
    sc.settings.maxTraceDepth = 2
    sc.camera = T.Camera(pos=(0, 60, -120), yaw=0, pitch=-15, fov=90)
    sc.camera.set_frame_size(width, height)
    sc.lights.append(T.PointLight(pos=(60, 180, -60), color=(1, 1, 1), power=40000))
    lam = T.Lambert(name="l", color=(0.7, 0.7, 0.7))
    sc.shaders.append(lam)
    bt = T.BumpTexture(name="bt", scaling=0.05, data=_heightmap())
    bt.strength = 8.0
    sc.textures.append(bt)

    def node(name, geom, transform=None, bumped=True):
        sc.geometries.append(geom)
        n = T.Node(name=name, geometry=geom, shader=lam)
        if transform:
            transform(n.transform)
        if bump and bumped:
            n.bumpmap = bt
        sc.nodes.append(n)

    node("floor", T.Plane(name="p", y=0, limit=200))
    node("ball", T.Sphere(name="s", center=(0, 40, 30), R=30.0))
    node(
        "box",
        T.Cube(name="c", center=(0, 0, 0), side=30.0),
        transform=lambda tr: (tr.scale(1.5, 1.0, 1.0), tr.translate((-60, 20, 10))),
    )
    node(
        "csg",
        T.CsgDiff(
            name="d",
            left=T.Sphere(name="ds", center=(60, 25, 0), R=25.0),
            right=T.Sphere(name="ds2", center=(60, 40, -15), R=20.0),
        ),
        bumped=csg_bump,
    )
    return pack_scene(sc, dtype=jnp.float32)


def fd_check(packed, static, key):
    """Central-difference check of d(loss)/d(bump-strength scale).

    The autodiff side differentiates w.r.t. the FULL ScenePacked pytree
    and takes the directional derivative along bump_strength (dL/ds at
    s=1 == <dL/dstrength, strength>): the full-pytree grad is exactly
    the graph the fit compiles and runs."""

    def loss(s):
        p = dataclasses.replace(packed, bump_strength=packed.bump_strength * s)
        return (render_frame(p, static, key) ** 2).mean()

    g_packed = jax.jit(
        jax.grad(lambda p: (render_frame(p, static, key) ** 2).mean())
    )(packed)
    g = float((g_packed.bump_strength * packed.bump_strength).sum())
    # h must stay under the cos_t > 0 kink spacing: unlike light power
    # (linear in the shading), strength moves lighting CUTOFF thresholds,
    # so the loss is piecewise-smooth: a large h reads tens of percent off
    # (kink crossings); 3e-4 stays under the kink spacing (kink density
    # grows with the lane count)
    h = 3e-4
    fd = (
        float(jax.jit(loss)(jnp.float32(1.0 + h)))
        - float(jax.jit(loss)(jnp.float32(1.0 - h)))
    ) / (2 * h)
    rel = abs(g - fd) / max(abs(fd), 1e-12)
    print(f"FD check (bump strength): autodiff {g:.6e} vs central-diff {fd:.6e} (rel {rel:.2e})")
    return rel < 2e-2 and g != 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="160x120")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    packed, static = build(w, h, bump=True, csg_bump=False)
    static = dataclasses.replace(static, aa_enabled=False, use_pallas=not args.cpu)
    from chess2rt_tpu.ops.pallas_grad import _fast_bump_ok

    assert _fast_bump_ok(static), "demo scene must take the fast bump forward"
    key = jax.random.PRNGKey(7)
    target = render_frame(packed, static, key)
    print(f"# backend {jax.default_backend()}; {w}x{h}, bump hybrid fast path")

    wrong = dataclasses.replace(
        packed,
        bump_strength=packed.bump_strength * 0.3,
        mat_color=packed.mat_color * 0.6,
    )

    log = lambda i, l: (i % 25 == 0) and print(f"step {i}: loss {l:.3e}")  # noqa: E731
    prob = InverseProblem(
        static=static, target=target,
        train_fields=("bump_strength", "mat_color"),
        learning_rate=2e-2, steps=args.steps,
        # strength is O(8) while albedo is O(1): matching Adam scale
        update_scales={"bump_strength": 4.0},
    )
    fitted, losses = fit(wrong, prob, key=key, on_step=log)

    bumped = np.asarray([ns.bump_idx >= 0 for ns in static.nodes])
    err_strength = float(
        jnp.abs(fitted.bump_strength - packed.bump_strength)[bumped].max()
        / jnp.abs(packed.bump_strength)[bumped].max()
    )
    err_albedo = float(jnp.abs(fitted.mat_color - packed.mat_color).max())
    print(
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e}; bump strength rel err "
        f"{err_strength:.4f}; albedo err {err_albedo:.4f}"
    )

    fd_ok = fd_check(packed, static, key)
    ok = (
        losses[-1] < losses[0] * 0.02
        and err_strength < 0.02
        and err_albedo < 0.02
        and fd_ok
    )
    print("RECOVERED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
