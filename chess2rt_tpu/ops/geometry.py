"""Device-side geometry intersection (JAX/XLA).

Wavefront re-design of the reference intersectors (source/rt/geometry.d,
source/rt/node.d):

* All ops are batched over a flat ray set ``orig/dir [N, 3]`` and return
  *candidate* hits; the caller merges candidates with a ``dist``-compare
  select — the array form of the "only improve data.dist" contract
  (intersectable.d:35-59).
* CSG uses **analytic all-hits enumeration** instead of the reference's
  epsilon-re-casting loop (geometry.d:271-290): every leaf reports all of
  its non-negative-t hits (sphere: both quadratic roots; cube: its two slab
  crossings; plane: one), the lists are merged in a fixed-capacity sorted
  array and the inside/outside parity walk is evaluated with cumulative
  sums.  This is mathematically the same sequence of hits the re-cast loop
  visits (each re-cast finds the next root), minus the accumulated 1e-6
  origin-advance drift — i.e. *more* accurate, with static shapes XLA can
  fuse.
* The cube drops the reference's axis-permutation trick (geometry.d:172-197)
  for a direct 6-slab test with identical face UV conventions.

Hit sets are dicts of arrays: dist [N,K], p [N,K,3], normal [N,K,3],
u [N,K], v [N,K], sorted ascending by dist with +INF padding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.packed import ScenePacked, max_hits

INF = 1e30


def _norm(v):
    # tiny floor keeps dead-lane zero vectors NaN-free (their results are
    # masked out); real geometry normals/directions are far above it
    return v / jnp.sqrt(jnp.maximum((v * v).sum(-1, keepdims=True), 1e-30))


def dot(a, b):
    return (a * b).sum(-1)


# --------------------------------------------------------------------------
# Leaf candidates (closest hit) — geometry.d:30-59, :92-125, :172-235
# --------------------------------------------------------------------------


def _const_vec(like, xyz):
    return jnp.broadcast_to(jnp.asarray(xyz, like.dtype), like.shape)


def plane_closest(y, limit, orig, dir, tangents=False):
    """Plane candidate.  Returns a hit dict with dist=INF on miss.

    ``tangents`` adds the dNdx/dNdy tangent frame (intersectable.d:24-25,
    geometry.d:52-53) — consumed only by the bump-map extension, so hot
    paths skip it."""
    oy, dy = orig[..., 1], dir[..., 1]
    miss = ((oy > y) & (dy > -1e-9)) | ((oy < y) & (dy < 1e-9))
    # guarded reciprocal: dy == 0 lanes are all misses (or the measure-zero
    # in-plane ray, excluded below) — keep them finite for nan-sweeps
    nonzero = dy != 0
    mult = (oy - y) * jnp.where(nonzero, -1.0 / jnp.where(nonzero, dy, 1.0), 0.0)
    p = orig + dir * mult[..., None]
    ok = ~miss & nonzero & (jnp.abs(p[..., 0]) <= limit) & (jnp.abs(p[..., 2]) <= limit)
    dist = jnp.where(ok, mult, INF)
    n = jnp.zeros_like(p).at[..., 1].set(1.0)
    rec = {"dist": dist, "p": p, "normal": n, "u": p[..., 0], "v": p[..., 2]}
    if tangents:
        rec["dndx"] = _const_vec(p, (1.0, 0.0, 0.0))
        rec["dndy"] = _const_vec(p, (0.0, 0.0, 1.0))
    return rec


@jax.custom_jvp
def _safe_arcsin(x):
    return jnp.arcsin(x)


@_safe_arcsin.defjvp
def _safe_arcsin_jvp(primals, tangents):
    # arcsin' = 1/sqrt(1-x^2) is infinite at |x| = 1: a ray hitting a
    # sphere's exact pole poisons EVERY upstream gradient (sphere params,
    # camera) with NaN.  Forward stays exact; the derivative is clamped —
    # the standard differentiable-rendering compromise at a UV singularity.
    (x,), (t,) = primals, tangents
    return jnp.arcsin(x), t * jax.lax.rsqrt(jnp.maximum(1.0 - x * x, 1e-12))


@jax.custom_jvp
def _safe_arctan2(y, x):
    return jnp.arctan2(y, x)


@_safe_arctan2.defjvp
def _safe_arctan2_jvp(primals, tangents):
    # d atan2 = (x dy - y dx) / (x^2 + y^2): NaN at the origin (a pole
    # hit, where rel_x = rel_z = 0).  Same clamp rationale as _safe_arcsin.
    (y, x), (ty, tx) = primals, tangents
    denom = jnp.maximum(x * x + y * y, 1e-12)
    return jnp.arctan2(y, x), (x * ty - y * tx) / denom


def _sphere_record(center, r, orig, dir, t, tangents=False):
    p = orig + dir * t[..., None]
    rel = p - center
    normal = _norm(rel)
    angle = _safe_arctan2(rel[..., 2], rel[..., 0])
    u = (jnp.pi + angle) / (2 * jnp.pi)
    v = 1.0 - (jnp.pi / 2 + _safe_arcsin(jnp.clip(rel[..., 1] / r, -1.0, 1.0))) / jnp.pi
    rec = {"p": p, "normal": normal, "u": u, "v": v}
    if tangents:
        # geometry.d:121-122: dNdx from the azimuth, dNdy = dNdx x normal
        dndx = jnp.stack(
            [jnp.cos(angle + jnp.pi / 2), jnp.zeros_like(angle), jnp.sin(angle + jnp.pi / 2)],
            axis=-1,
        )
        rec["dndx"] = dndx
        rec["dndy"] = jnp.cross(dndx, normal)
    return rec


@jax.custom_jvp
def _safe_sqrt(x):
    return jnp.sqrt(x)


@_safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    # sqrt' = 1/(2 sqrt(x)) is infinite at x = 0: a ray exactly grazing a
    # sphere (discriminant 0 — fp-real where the fused kernel's
    # arithmetic can report a hit the XLA backward recompute sees at
    # D <= 0) poisons sphere/offset/camera gradients with inf.  Forward
    # stays exact; the derivative is clamped like _safe_arcsin's.
    (x,), (t,) = primals, tangents
    return jnp.sqrt(x), t * 0.5 * jax.lax.rsqrt(jnp.maximum(x, 1e-8))


def _sphere_roots(center, r, orig, dir):
    H = orig - center
    A = dot(dir, dir)
    B = 2.0 * dot(H, dir)
    C = dot(H, H) - r * r
    Dscr = B * B - 4.0 * A * C
    has = Dscr >= 0
    sq = _safe_sqrt(jnp.where(has, Dscr, 0.0))
    x1 = (-B + sq) / (2.0 * A)
    x2 = (-B - sq) / (2.0 * A)
    return has, x1, x2


def sphere_closest(center, r, orig, dir, tangents=False):
    has, x1, x2 = _sphere_roots(center, r, orig, dir)
    sol = jnp.where(x2 < 0, x1, x2)  # nearer root unless behind us (geometry.d:104-108)
    ok = has & (sol >= 0)
    dist = jnp.where(ok, sol, INF)
    rec = _sphere_record(center, r, orig, dir, jnp.where(ok, sol, 0.0), tangents)
    rec["dist"] = dist
    return rec


_CUBE_FACES = (
    # (axis, sign, u_axis, v_axis) in reference processing order
    (1, -1.0, 0, 2),
    (1, 1.0, 0, 2),
    (0, -1.0, 1, 2),
    (0, 1.0, 1, 2),
    (2, -1.0, 0, 1),
    (2, 1.0, 0, 1),
)


def _cube_face_candidates(center, side, orig, dir, tangents=False):
    """Per-face candidate (dist, normal, u, v) for all 6 faces -> [N, 6, ...].

    Tangent-frame quirk preserved (geometry.d:178-191, :227-228): the
    reference unprojects normal and p after the axis-permuted side tests
    but NOT dNdx/dNdy, so every face keeps the projected-space literals
    dNdx = (1, 0, 0), dNdy = (0, 0, face_sign)."""
    half = side * 0.5
    dists, normals, us, vs, ps = [], [], [], [], []
    dndys = []
    for axis, s, ua, va in _CUBE_FACES:
        d_k = dir[..., axis]
        o_k = orig[..., axis]
        valid = jnp.abs(d_k) >= 1e-9
        inv_d = jnp.where(valid, -1.0 / jnp.where(valid, d_k, 1.0), 0.0)
        mult = (o_k - (center[..., axis] + s * half)) * inv_d
        p = orig + dir * mult[..., None]
        oa, ob = (axis + 1) % 3, (axis + 2) % 3
        inside = (
            (p[..., oa] >= center[..., oa] - half)
            & (p[..., oa] <= center[..., oa] + half)
            & (p[..., ob] >= center[..., ob] - half)
            & (p[..., ob] <= center[..., ob] + half)
        )
        ok = valid & (mult >= 0) & inside & jnp.isfinite(mult)
        n = jnp.zeros_like(p).at[..., axis].set(s)
        dists.append(jnp.where(ok, mult, INF))
        normals.append(n)
        us.append(p[..., ua] - center[..., ua])
        vs.append(p[..., va] - center[..., va])
        ps.append(p)
        if tangents:
            dndys.append(_const_vec(p, (0.0, 0.0, s)))
    stack = lambda xs, ax=-1: jnp.stack(xs, axis=ax)  # noqa: E731
    out = {
        "dist": stack(dists),  # [N, 6]
        "normal": stack(normals, -2),  # [N, 6, 3]
        "u": stack(us),
        "v": stack(vs),
        "p": stack(ps, -2),
    }
    if tangents:
        out["dndx"] = jnp.broadcast_to(
            jnp.asarray((1.0, 0.0, 0.0), orig.dtype), out["normal"].shape
        )
        out["dndy"] = stack(dndys, -2)
    return out


def cube_closest(center, side, orig, dir, tangents=False):
    """Running-min select over the 6 faces (no argmin + per-ray gather)."""
    faces = _cube_face_candidates(center, side, orig, dir, tangents)
    vec_keys = ("normal", "p", "dndx", "dndy") if tangents else ("normal", "p")
    scal_keys = ("dist", "u", "v")
    best = {k: faces[k][..., 0] for k in scal_keys}
    best.update({k: faces[k][..., 0, :] for k in vec_keys})
    for i in range(1, 6):
        better = faces["dist"][..., i] < best["dist"]
        bv = better[..., None]
        for k in scal_keys:
            best[k] = jnp.where(better, faces[k][..., i], best[k])
        for k in vec_keys:
            best[k] = jnp.where(bv, faces[k][..., i, :], best[k])
    return best


# --------------------------------------------------------------------------
# All-hits enumeration for CSG
# --------------------------------------------------------------------------


def _oddeven_pairs(n: int):
    """Batcher odd-even mergesort compare-exchange pairs for n slots.
    Static network -> pure min/max selects, NO gathers (argsort +
    take_along_axis lower to per-ray gathers)."""
    pairs = []

    def merge(lo, nn, r):
        step = r * 2
        if step < nn:
            merge(lo, nn, step)
            merge(lo + r, nn, step)
            for i in range(lo + r, lo + nn - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, nn):
        if nn > 1:
            m = nn // 2
            sort(lo, m)
            sort(lo + m, nn - m)
            merge(lo, nn, 1)

    # pad virtually to a power of two by clamping out-of-range pairs
    n2 = 1
    while n2 < n:
        n2 *= 2
    sort(0, n2)
    return [(i, j) for (i, j) in pairs if i < n and j < n]


def _sort_hit_fields(fields: dict, key: str = "dist"):
    """In-place-style network sort of a dict of [N, K(, 3)] arrays by
    ``fields[key]`` ascending.  Slot accesses are static indices."""
    k = fields[key].shape[-1]
    cols = {name: [a[..., i, :] if a.ndim > fields[key].ndim else a[..., i] for i in range(k)] for name, a in fields.items()}
    for i, j in _oddeven_pairs(k):
        swap = cols[key][i] > cols[key][j]
        for name in cols:
            ci, cj = cols[name][i], cols[name][j]
            sw = swap[..., None] if ci.ndim > swap.ndim else swap
            cols[name][i] = jnp.where(sw, cj, ci)
            cols[name][j] = jnp.where(sw, ci, cj)
    out = {}
    for name, a in fields.items():
        axis = -2 if a.ndim > fields[key].ndim else -1
        out[name] = jnp.stack(cols[name], axis=axis)
    return out


def _sort_hits(hits, extra=None):
    """Sort a hit set by distance (see _oddeven_pairs).  ``extra``: optional
    dict of [N, K] companion fields sorted along."""
    fields = dict(hits)
    if extra:
        fields.update(extra)
    out = _sort_hit_fields(fields)
    if extra:
        return {k: out[k] for k in hits}, {k: out[k] for k in extra}
    return {k: out[k] for k in hits}, None


def _vec_keys(hits):
    """Hit-set fields carrying [..., 3] vectors (vs per-hit scalars)."""
    return tuple(k for k in hits if k in ("p", "normal", "dndx", "dndy"))


def plane_all_hits(y, limit, orig, dir, tangents=False):
    c = plane_closest(y, limit, orig, dir, tangents)
    vk = _vec_keys(c)
    return {k: v[..., None, :] if k in vk else v[..., None] for k, v in c.items()}


def sphere_all_hits(center, r, orig, dir, tangents=False):
    """Both quadratic roots with t >= 0, ascending (= what the re-cast loop
    enumerates, geometry.d:271-290)."""
    has, x1, x2 = _sphere_roots(center, r, orig, dir)  # x2 <= x1
    ok2 = has & (x2 >= 0)
    ok1 = has & (x1 >= 0)
    d = jnp.stack([jnp.where(ok2, x2, INF), jnp.where(ok1, x1, INF)], axis=-1)
    recs = [_sphere_record(center, r, orig, dir, t, tangents) for t in (x2, x1)]
    out = {"dist": d}
    for k in recs[0]:
        ax = -2 if k in ("p", "normal", "dndx", "dndy") else -1
        out[k] = jnp.stack([rc[k] for rc in recs], axis=ax)
    return out


def cube_all_hits(center, side, orig, dir, tangents=False):
    """The (<= 2) valid face crossings, ascending."""
    faces = _cube_face_candidates(center, side, orig, dir, tangents)
    sorted_faces, _ = _sort_hits(faces)
    vk = _vec_keys(sorted_faces)
    return {
        k: (v[..., :2, :] if k in vk else v[..., :2]) for k, v in sorted_faces.items()
    }


# --------------------------------------------------------------------------
# Inside tests (geometry.d:25-28, :127-130, :165-170, :334-337)
# --------------------------------------------------------------------------


def is_inside_expr(packed: ScenePacked, expr, p):
    kind = expr[0]
    if kind == "plane":
        return jnp.zeros(p.shape[:-1], dtype=bool)
    if kind == "sphere":
        c, r = packed.sphere_center[expr[1]], packed.sphere_r[expr[1]]
        rel = c - p
        return dot(rel, rel) < r * r
    if kind == "cube":
        c, s = packed.cube_center[expr[1]], packed.cube_side[expr[1]]
        return (jnp.abs(p - c) <= s * 0.5).all(-1)
    _, op, left, right = expr
    il = is_inside_expr(packed, left, p)
    ir = is_inside_expr(packed, right, p)
    return _bool_op(op, il, ir)


def _bool_op(op, il, ir):
    if op == "union":
        return il | ir
    if op == "inter":
        return il & ir
    return il & ~ir  # diff


# --------------------------------------------------------------------------
# Geometry-expression dispatch
# --------------------------------------------------------------------------


def all_hits_expr(packed: ScenePacked, expr, orig, dir, tangents=False):
    """All boundary crossings of the solid described by ``expr`` along the
    ray, as a sorted fixed-capacity hit set.

    For a CSG node this reproduces what the reference's
    findAllIntersections + parity walk enumerates: the subset of child hits
    at which boolOp(inL, inR) is true *after* the flip (see geometry.d:
    292-332 and the derivation in this module's docstring)."""
    kind = expr[0]
    if kind == "plane":
        return plane_all_hits(packed.plane_y[expr[1]], packed.plane_limit[expr[1]], orig, dir, tangents)
    if kind == "sphere":
        return sphere_all_hits(packed.sphere_center[expr[1]], packed.sphere_r[expr[1]], orig, dir, tangents)
    if kind == "cube":
        return cube_all_hits(packed.cube_center[expr[1]], packed.cube_side[expr[1]], orig, dir, tangents)

    _, op, left, right = expr
    lh = all_hits_expr(packed, left, orig, dir, tangents)
    rh = all_hits_expr(packed, right, orig, dir, tangents)
    kl = lh["dist"].shape[-1]

    vk = _vec_keys(lh)
    merged = {
        k: jnp.concatenate([lh[k], rh[k]], axis=-2 if k in vk else -1) for k in lh
    }
    side_flag = jnp.concatenate(
        [jnp.zeros_like(lh["dist"]), jnp.ones_like(rh["dist"])], axis=-1
    )
    shits, extra = _sort_hits(merged, extra={"side": side_flag})
    valid = shits["dist"] < INF
    from_right = extra["side"] > 0.5

    # Initial parity: odd hit count -> ray starts inside (geometry.d:307-309).
    in_l0 = (lh["dist"] < INF).sum(-1) % 2 == 1
    in_r0 = (rh["dist"] < INF).sum(-1) % 2 == 1

    flips_l = jnp.cumsum((~from_right & valid).astype(jnp.int32), axis=-1)
    flips_r = jnp.cumsum((from_right & valid).astype(jnp.int32), axis=-1)
    in_l = in_l0[..., None] ^ (flips_l % 2 == 1)
    in_r = in_r0[..., None] ^ (flips_r % 2 == 1)
    state = _bool_op(op, in_l, in_r) & valid

    # CsgDiff normal flip (geometry.d:377-397): on the "eaten-out" surface
    # (the subtracted child's skin) the stored normal points into the solid;
    # detect by comparing right.isInside just before/after the hit point.
    if op == "diff":
        # probe step: 1e-6 like the reference in f64; under f32 that is
        # BELOW one ulp at the reference scenes' coordinate scale (~1e2),
        # so p +- dir*1e-6 == p and the flip silently never fires — widen
        # to 1e-3, the same dtype split as ops/shade.shadow_eps
        eps = 1e-6 if shits["p"].dtype == jnp.float64 else 1e-3
        eps_step = shits["p"] + dir[..., None, :] * eps
        eps_back = shits["p"] - dir[..., None, :] * eps
        before = is_inside_expr(packed, right, eps_back)
        after = is_inside_expr(packed, right, eps_step)
        flip = (before != after) & state
        shits["normal"] = jnp.where(flip[..., None], -shits["normal"], shits["normal"])

    shits["dist"] = jnp.where(state, shits["dist"], INF)
    # compact: re-sort so surviving hits lead and padding trails
    out, _ = _sort_hits(shits)
    return out


def closest_hit_expr(packed: ScenePacked, expr, orig, dir, tangents=False):
    """Closest-hit candidate of a geometry expression (dist=INF on miss)."""
    kind = expr[0]
    if kind == "plane":
        return plane_closest(packed.plane_y[expr[1]], packed.plane_limit[expr[1]], orig, dir, tangents)
    if kind == "sphere":
        return sphere_closest(packed.sphere_center[expr[1]], packed.sphere_r[expr[1]], orig, dir, tangents)
    if kind == "cube":
        return cube_closest(packed.cube_center[expr[1]], packed.cube_side[expr[1]], orig, dir, tangents)
    hits = all_hits_expr(packed, expr, orig, dir, tangents)
    vk = _vec_keys(hits)
    return {k: (v[..., 0, :] if k in vk else v[..., 0]) for k, v in hits.items()}


# --------------------------------------------------------------------------
# Node = geometry + transform (node.d:23-68)
# --------------------------------------------------------------------------


def node_closest(packed: ScenePacked, node_static, node_idx, orig, dir, tangents=False):
    """Closest-hit candidate for one scene node, in world space.

    Implements the canonic-space round trip with the |dir| distance
    rescaling derivation from node.d:51-67.  Identity / offset-only
    transforms take statically cheaper paths."""
    if node_static.identity_transform:
        return closest_hit_expr(packed, node_static.geom, orig, dir, tangents)

    offset = packed.node_offset[node_idx]
    if node_static.offset_only:
        cand = closest_hit_expr(packed, node_static.geom, orig - offset, dir, tangents)
        cand["p"] = cand["p"] + offset
        return cand

    m = packed.node_matrix[node_idx]
    m_inv = jnp.linalg.inv(m)
    co = (orig - offset) @ m_inv
    cd = dir @ m_inv
    dlen = jnp.sqrt(dot(cd, cd))
    cdn = cd / dlen[..., None]
    cand = closest_hit_expr(packed, node_static.geom, co, cdn, tangents)
    miss = cand["dist"] >= INF
    out = {
        "dist": jnp.where(miss, INF, cand["dist"] / dlen),
        "p": cand["p"] @ m + offset,
        "normal": _norm(cand["normal"] @ m_inv.T),
        "u": cand["u"],
        "v": cand["v"],
    }
    if tangents:
        # node.d:45-46: transform.direction (the forward matrix) + normalize
        out["dndx"] = _norm(cand["dndx"] @ m)
        out["dndy"] = _norm(cand["dndy"] @ m)
    return out


def scene_closest(packed: ScenePacked, static, orig, dir, tangents=False):
    """The node-scan hot loop (renderer.d:336-338): linear scan over all
    nodes, last improving node wins; returns (hit, win) with win == -1 for
    misses.  The static Python loop unrolls at trace time and XLA fuses the
    whole scan into one kernel.

    ``tangents`` carries the dNdx/dNdy frame through the records (for the
    bump-map extension); hot paths leave it off."""
    best = None
    win = jnp.full(orig.shape[:-1], -1, dtype=jnp.int32)
    for i, ns in enumerate(static.nodes):
        cand = node_closest(packed, ns, i, orig, dir, tangents)
        if best is None:
            best = cand
            win = jnp.where(cand["dist"] < INF, i, win)
        else:
            better = cand["dist"] <= best["dist"]  # ties: later node wins, like the reference
            improved = better & (cand["dist"] < INF)
            win = jnp.where(improved, i, win)
            vk = _vec_keys(best)
            best = {
                k: jnp.where(better[..., None] if k in vk else better, cand[k], best[k])
                for k in best
            }
    if best is None:  # empty scene
        z = jnp.zeros(orig.shape[:-1], dtype=orig.dtype)
        best = {"dist": jnp.full_like(z, INF), "p": orig, "normal": dir, "u": z, "v": z}
        if tangents:
            best["dndx"] = jnp.zeros_like(orig)
            best["dndy"] = jnp.zeros_like(orig)
    return best, win


# --------------------------------------------------------------------------
# Distance-only any-hit (shadow rays)
# --------------------------------------------------------------------------
#
# Shadow tests only need "is there a hit with dist <= target" — none of the
# record fields (normal/UV/p) the closest-hit path computes.  These
# dist-only variants cut the shadow-scan cost roughly in half; the Shadow
# RayFlags hint in the reference exists for exactly this reason (ray.d:15-17).


def _plane_dist(y, limit, orig, dir):
    oy, dy = orig[..., 1], dir[..., 1]
    miss = ((oy > y) & (dy > -1e-9)) | ((oy < y) & (dy < 1e-9))
    nonzero = dy != 0
    mult = (oy - y) * jnp.where(nonzero, -1.0 / jnp.where(nonzero, dy, 1.0), 0.0)
    px = orig[..., 0] + dir[..., 0] * mult
    pz = orig[..., 2] + dir[..., 2] * mult
    ok = ~miss & nonzero & (jnp.abs(px) <= limit) & (jnp.abs(pz) <= limit)
    return jnp.where(ok, mult, INF)[..., None]  # [N, 1] hit list


def _sphere_dists(center, r, orig, dir):
    has, x1, x2 = _sphere_roots(center, r, orig, dir)
    d2 = jnp.where(has & (x2 >= 0), x2, INF)
    d1 = jnp.where(has & (x1 >= 0), x1, INF)
    return jnp.stack([d2, d1], axis=-1)


def _cube_dists(center, side, orig, dir):
    """Slab-method (t_enter, t_exit): a fraction of the six-face test's
    ops — dist-only callers (shadow scans, CSG interval walks) don't need
    face identity.  Axis-parallel rays (d_k ~ 0) outside the slab produce
    +/-inf bounds through the guarded reciprocal, which the final min/max
    handles exactly like the reference's per-face miss."""
    half = side * 0.5
    t_enter = None
    t_exit = None
    for axis in range(3):
        d_k = dir[..., axis]
        o_k = orig[..., axis]
        ok = jnp.abs(d_k) >= 1e-9
        inv = 1.0 / jnp.where(ok, d_k, 1.0)
        t1 = (center[..., axis] - half - o_k) * inv
        t2 = (center[..., axis] + half - o_k) * inv
        tn = jnp.minimum(t1, t2)
        tf = jnp.maximum(t1, t2)
        # parallel ray: inside the slab -> (-INF, INF); outside -> miss
        inside = (o_k >= center[..., axis] - half) & (o_k <= center[..., axis] + half)
        tn = jnp.where(ok, tn, jnp.where(inside, -INF, INF))
        tf = jnp.where(ok, tf, jnp.where(inside, INF, -INF))
        t_enter = tn if t_enter is None else jnp.maximum(t_enter, tn)
        t_exit = tf if t_exit is None else jnp.minimum(t_exit, tf)
    hit = (t_enter <= t_exit) & (t_exit >= 0)
    d1 = jnp.where(hit & (t_enter >= 0), t_enter, INF)
    d2 = jnp.where(hit, t_exit, INF)
    return jnp.stack([jnp.minimum(d1, d2), jnp.maximum(d1, d2)], axis=-1)


def all_hit_dists_expr(packed: ScenePacked, expr, orig, dir):
    """Sorted hit distances only (the all_hits_expr parity walk without
    record fields)."""
    kind = expr[0]
    if kind == "plane":
        return _plane_dist(packed.plane_y[expr[1]], packed.plane_limit[expr[1]], orig, dir)
    if kind == "sphere":
        return _sphere_dists(packed.sphere_center[expr[1]], packed.sphere_r[expr[1]], orig, dir)
    if kind == "cube":
        return _cube_dists(packed.cube_center[expr[1]], packed.cube_side[expr[1]], orig, dir)
    _, op, left, right = expr
    ld = all_hit_dists_expr(packed, left, orig, dir)
    rd = all_hit_dists_expr(packed, right, orig, dir)
    dist = jnp.concatenate([ld, rd], axis=-1)
    side = jnp.concatenate([jnp.zeros_like(ld), jnp.ones_like(rd)], axis=-1)
    s = _sort_hit_fields({"dist": dist, "side": side})
    sdist = s["dist"]
    valid = sdist < INF
    from_right = s["side"] > 0.5
    in_l0 = (ld < INF).sum(-1) % 2 == 1
    in_r0 = (rd < INF).sum(-1) % 2 == 1
    flips_l = jnp.cumsum((~from_right & valid).astype(jnp.int32), axis=-1)
    flips_r = jnp.cumsum((from_right & valid).astype(jnp.int32), axis=-1)
    in_l = in_l0[..., None] ^ (flips_l % 2 == 1)
    in_r = in_r0[..., None] ^ (flips_r % 2 == 1)
    state = _bool_op(op, in_l, in_r) & valid
    return _sort_hit_fields({"dist": jnp.where(state, sdist, INF)})["dist"]


def node_closest_dist(packed: ScenePacked, node_static, node_idx, orig, dir):
    """Closest-hit distance only, world space (the node.d:23-68 rescaling
    without record transforms).

    NB the min() (not slot 0): leaf sphere hit lists are [x2, x1] with
    INF-masked invalid roots, UNsorted — a ray starting inside a sphere has
    x2 < 0 <= x1, so slot 0 would miss the far-root hit the reference's
    intersect reports (geometry.d:104-108)."""
    if node_static.identity_transform:
        return all_hit_dists_expr(packed, node_static.geom, orig, dir).min(-1)
    offset = packed.node_offset[node_idx]
    if node_static.offset_only:
        return all_hit_dists_expr(packed, node_static.geom, orig - offset, dir).min(-1)
    m_inv = jnp.linalg.inv(packed.node_matrix[node_idx])
    co = (orig - offset) @ m_inv
    cd = dir @ m_inv
    dlen = jnp.sqrt(dot(cd, cd))
    d = all_hit_dists_expr(packed, node_static.geom, co, cd / dlen[..., None]).min(-1)
    return jnp.where(d >= INF, INF, d / dlen)


def test_visibility(packed: ScenePacked, static, from_p, to_p):
    """Scene.testVisibility (scene.d:62-78): True = unoccluded.  A single
    batched dist-only any-hit pass over all nodes."""
    d = to_p - from_p
    target = jnp.sqrt(dot(d, d))
    dir = d / target[..., None]
    occluded = jnp.zeros(from_p.shape[:-1], dtype=bool)
    for i, ns in enumerate(static.nodes):
        occluded |= node_closest_dist(packed, ns, i, from_p, dir) <= target
    return ~occluded
