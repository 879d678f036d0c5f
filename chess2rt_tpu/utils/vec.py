"""3-vector math on `[..., 3]` arrays.

Works with either numpy or jax.numpy inputs (all functions are pure and only
use operators / ufuncs available in both).  The reference keeps geometry in
`vec3d` (double); the device path uses float32 arrays shaped `[..., 3]` and the
oracle uses float64 (reference: source/rt/imported_types.d).
"""

from __future__ import annotations

import numpy as np


def _xp(a):
    if isinstance(a, np.ndarray) or np.isscalar(a):
        return np
    import jax.numpy as jnp

    return jnp


def dot(a, b):
    """Row-wise dot product of `[..., 3]` arrays -> `[...]`."""
    return (a * b).sum(axis=-1)


def length(v):
    return _xp(v).sqrt((v * v).sum(axis=-1))


def squared_length(v):
    return (v * v).sum(axis=-1)


def normalize(v):
    """v / |v|.  No epsilon: the reference normalizes unconditionally."""
    return v / length(v)[..., None]


def normalize_guarded(v):
    """normalize, but zero-length rows pass through unchanged (as zeros).

    The guarded-reciprocal pattern for masked/dead lanes (CLAUDE.md
    invariant: masked lanes must stay NaN-free).  Bit-identical to
    `normalize` on every row with |v| > 0 — the guard only replaces the
    0/0 = NaN rows, whose results callers discard via their masks.
    """
    xp = _xp(v)
    l = length(v)
    return v / xp.where(l > 0.0, l, 1.0)[..., None]


def cross(a, b):
    return _xp(a).stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def reflect(ray, norm):
    """Mirror `ray` about `norm` and normalize the result.

    NB: the reference's `reflect` normalizes its output
    (imported_types.d:62-67); keep that.
    """
    return normalize(ray - 2.0 * dot(ray, norm)[..., None] * norm)


def faceforward(ray, norm):
    """Return `norm` turned towards the viewer.

    Matches imported_types.d:69-73: `+norm` when dot(ray, norm) < 0,
    else `-norm` (note: dot == 0 returns -norm, like the reference).
    """
    return _xp(ray).where((dot(ray, norm) < 0.0)[..., None], norm, -norm)


def mul_vm(v, m):
    """Row-vector times 3x3 matrix: result_j = sum_i v_i * m[i, j].

    Matches `mul(v, m)` in imported_types.d:13-20 where `m.c[i][j]` is the
    element at row i / column j.  `v` is `[..., 3]`, `m` is `[..., 3, 3]`
    (broadcastable).
    """
    return (v[..., :, None] * m).sum(axis=-2)


def project(v, a, b, c):
    """Axis permutation used by Cube: result[a]=v[0], result[b]=v[1], result[c]=v[2].

    (imported_types.d:44-51)
    """
    out = [None, None, None]
    out[a] = v[..., 0]
    out[b] = v[..., 1]
    out[c] = v[..., 2]
    return _xp(v).stack(out, axis=-1)


def unproject(v, a, b, c):
    """Inverse permutation: result = (v[a], v[b], v[c]).  (imported_types.d:53-60)"""
    return _xp(v).stack([v[..., a], v[..., b], v[..., c]], axis=-1)


# ---------------------------------------------------------------------------
# Rotation matrices, matching gfm.math.matrix's rotateX/rotateY/rotateZ
# convention used by the reference:
#   rotateX = rotateAxis!(1, 2):  c[1][1]=cos, c[1][2]=-sin, c[2][1]=sin, c[2][2]=cos
#   rotateY = rotateAxis!(2, 0):  c[2][2]=cos, c[2][0]=-sin, c[0][2]=sin, c[0][0]=cos
#   rotateZ = rotateAxis!(0, 1):  c[0][0]=cos, c[0][1]=-sin, c[1][0]=sin, c[1][1]=cos
# Vectors are multiplied as row vectors: mul(v, M)_j = sum_i v_i M[i][j]
# (imported_types.d:13-20), so in a product M_a @ M_b the factor M_a applies
# first.  These builders accept traced jax scalars too (pass xp=jax.numpy).
# ---------------------------------------------------------------------------


def _rot_axis(i, j, angle, xp):
    angle = xp.asarray(angle)
    c, s = xp.cos(angle), xp.sin(angle)
    one = xp.ones_like(c)
    zero = xp.zeros_like(c)
    cells = [[one if r == col else zero for col in range(3)] for r in range(3)]
    cells[i][i] = c
    cells[i][j] = -s
    cells[j][i] = s
    cells[j][j] = c
    return xp.stack([xp.stack(r, axis=-1) for r in cells], axis=-2)


def rotate_x(angle, xp=np):
    return _rot_axis(1, 2, angle, xp)


def rotate_y(angle, xp=np):
    return _rot_axis(2, 0, angle, xp)


def rotate_z(angle, xp=np):
    return _rot_axis(0, 1, angle, xp)


def scaled_identity(x, y, z, xp=np):
    """Diagonal scale matrix (imported_types.d scaledIdentity)."""
    x = xp.asarray(x, dtype=xp.float64 if xp is np else None)
    zero = xp.zeros_like(x)
    return xp.stack(
        [
            xp.stack([x + 0.0, zero, zero], axis=-1),
            xp.stack([zero, zero + y, zero], axis=-1),
            xp.stack([zero, zero, zero + z], axis=-1),
        ],
        axis=-2,
    )


def radians(deg):
    return deg * (np.pi / 180.0)
