"""Environment (miss shader).

The reference Environment returns black unconditionally (environment.d:5-15)
but is the declared hook for a cubemap skybox (the BASELINE zaphod config
lists one; the reference README credits a cubemap screenshot).  This module
implements the natural completion: a 6-face cubemap sampled by ray
direction with bilinear filtering, differentiable w.r.t. the texels.

Face layout (standard cube-mapping, major-axis projection):
    0:+X  1:-X  2:+Y  3:-Y  4:+Z  5:-Z
with per-face (u, v) from the two minor axes over the major magnitude.

Split into quads/plan/sample so the fused render path can MERGE the miss
gather with the deferred bitmap-texel gather into one per-ray row gather
(one index per ray instead of two).
"""

from __future__ import annotations

import jax.numpy as jnp


def cubemap_quads(cubemap):
    """[6, S, S, 3] -> flat quad table [6*S*S, 12]: each row holds the 2x2
    bilinear neighbourhood (t00|t10|t01|t11), neighbours clamping at face
    edges (cf. ops/shade._quad_atlas's per-texture wrap)."""
    size = cubemap.shape[1]
    xn = cubemap[:, :, 1:]
    xn = jnp.concatenate([xn, xn[:, :, -1:]], axis=2)
    yn = cubemap[:, 1:]
    yn = jnp.concatenate([yn, yn[:, -1:]], axis=1)
    xyn = yn[:, :, 1:]
    xyn = jnp.concatenate([xyn, xyn[:, :, -1:]], axis=2)
    quads = jnp.concatenate([cubemap, xn, yn, xyn], axis=-1)
    return quads.reshape(6 * size * size, 12)


def cubemap_plan(cubemap, dir):
    """-> (key, p, q): flat row index into :func:`cubemap_quads`' table and
    the bilinear fractions, for dir [..., 3] (need not be normalized)."""
    x, y, z = dir[..., 0], dir[..., 1], dir[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)

    # face + projective coords (sc, tc, ma) per the standard table
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)

    face = jnp.where(
        is_x,
        jnp.where(x > 0, 0, 1),
        jnp.where(is_y, jnp.where(y > 0, 2, 3), jnp.where(z > 0, 4, 5)),
    ).astype(jnp.int32)

    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    sc = jnp.where(
        is_x, jnp.where(x > 0, -z, z), jnp.where(is_y, x, jnp.where(z > 0, x, -x))
    )
    tc = jnp.where(is_x, -y, jnp.where(is_y, jnp.where(y > 0, z, -z), -y))

    s = (sc / ma + 1.0) * 0.5
    t = (tc / ma + 1.0) * 0.5

    size = cubemap.shape[1]
    fx = s * (size - 1)
    fy = t * (size - 1)
    x0 = jnp.clip(jnp.floor(fx), 0, size - 1).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(fy), 0, size - 1).astype(jnp.int32)
    p = (fx - x0)[..., None]
    q = (fy - y0)[..., None]
    return (face * size + y0) * size + x0, p, q


def sample_cubemap(cubemap, dir):
    """cubemap [6, S, S, 3], dir [..., 3] (need not be normalized) -> [..., 3]."""
    from .shade import bilerp_quad

    key, p, q = cubemap_plan(cubemap, dir)
    g = cubemap_quads(cubemap)[key]
    return bilerp_quad(g, p, q)
