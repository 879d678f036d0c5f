"""Fused primary-round render kernel (Pallas, Triton route) with deferred
texturing.

One kernel runs ray-gen, the closest hit over every node (CSG and matrix
transforms included), the per-light shadow scans and direct shading for a
block of rays, keeping each ray's whole chain in registers with no round
trip to device memory between stages.  The pure-XLA pipeline
(render/pipeline.py) remains the correctness anchor and the
differentiable reference.

Coverage (supports()):
  * geometries: plane / sphere / cube / nested CSG (union, inter, diff) —
    the CSG interval engine runs in-kernel as fixed-capacity
    compare-exchange sorting networks + an unrolled parity walk (mirrors
    ops/geometry.py all_hits_expr, itself the analytic re-design of the
    reference's re-cast loop, rt/geometry.d:250-403)
  * transforms: identity / offset / full 3x3 matrix with the node.d:51-67
    dist-rescaling algebra (inverses computed in-graph per call)
  * shading: Lambert / Phong / Reflection / Refraction (continuations —
    mirror or single-sided refraction with TIR fallback — are emitted as
    (orig, dir) and traced by the compacted bounce rounds; the live set
    is a few % of rays, exactly what compaction is for)
  * textures: flat / checker / procedure2 shaded in-kernel; bitmap
    textures are DEFERRED — the kernel emits (win, u, v) + the light sum
    and XLA performs the one 12-float quad gather (ops/shade.bitmap_color)
  * environment cubemap (miss rays sampled XLA-side)
  * DoF / stereo sampling (XLA generates the rays, the ray-input kernel
    traces them) and GI path tracing (build_gi_renderer: the want_hit
    kernel supplies hit records + NEE light sums, XLA does the BRDF
    sampling).  Every reference sampling mode and shader kind is covered.

Design notes
* One ray per thread: a program covers BLOCK rays with BLOCK // 32 warps,
  every vector quantity is three [BLOCK] values (SoA), and node/light
  loops unroll statically.
* Scene parameters arrive as one flat f32 vector, padded to a power of two
  and passed whole; the kernel reads it with scalar loads at static
  offsets (the same address in every thread, served by the caches).
* Gradients: the raw kernel has no VJP, but ops/pallas_grad.build_diff_round0
  wraps it in a custom VJP (backward = XLA re-shade with the kernel's
  discrete decisions pinned via the want_vis residuals); the flagship and
  GI renderers build their kernels through that wrapper, so
  jax.value_and_grad works through this module end-to-end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..models.packed import (
    LAMBERT,
    PHONG,
    REFLECTION,
    REFRACTION,
    TEX_BITMAP,
    TEX_CHECKER,
    TEX_NONE,
    TEX_PROC2,
    ScenePacked,
    SceneStatic,
)
from .camera import begin_frame
from .geometry import _oddeven_pairs

# rays per program, one per thread (a power of two and a BOUNCE_BLOCK
# multiple); demos/kernel_blocks.py times the alternatives (PERF.md)
BLOCK = 128
NUM_WARPS = BLOCK // 32
# bounce_mode="block" compaction granularity: small enough to ride the
# continuation set's screen locality, large enough that the compaction
# sort runs over n/128 block keys instead of n lanes
BOUNCE_BLOCK = 128
INF = 1e30
EPS_SHADOW = 1e-3  # f32 self-intersection offset (ops/shade.shadow_eps)


def supports(static: SceneStatic) -> bool:
    """True when the fused kernel covers this scene + sampling mode.

    DoF and stereo run through the ray-input kernel (XLA generates the
    jittered/offset rays with the same jax.random stream as the pure-XLA
    path, the kernel traces them); GI goes through build_gi_renderer
    (supports_gi) instead of this Whitted path."""
    if static.gi_enabled:
        return False
    return _supports_scene(static)


def _supports_scene(static: SceneStatic) -> bool:
    """Geometry/shader/texture coverage of the kernel, independent of the
    sampling mode (build_round0_kernel's own precondition)."""
    if not static.nodes:
        return False  # nothing to scan; the XLA path handles empty scenes
    if static.compensated_raygen:
        return False  # df32 ray-gen is an XLA-path opt-in (ops/camera.py)
    for ns in static.nodes:
        if ns.shader_kind not in (LAMBERT, PHONG, REFLECTION, REFRACTION):
            return False
        if ns.tex_kind not in (TEX_NONE, TEX_CHECKER, TEX_PROC2, TEX_BITMAP):
            return False
    return True


_PI = float(np.pi)


# --------------------------------------------------------------------------
# Record helpers (hits are dicts of [BLOCK] arrays)
# --------------------------------------------------------------------------

_REC_KEYS = ("t", "px", "py", "pz", "nx", "ny", "nz", "u", "v")


def _sel(m, a, b):
    """where(m, a, b) over two record dicts."""
    return {k: jnp.where(m, a[k], b[k]) for k in a}


def _ce_sort(hits, key="t"):
    """In-place compare-exchange sort of a list of record dicts by
    hits[i][key] ascending (gather-free; see ops/geometry._oddeven_pairs)."""
    for i, j in _oddeven_pairs(len(hits)):
        swap = hits[i][key] > hits[j][key]
        hi, hj = hits[i], hits[j]
        hits[i] = _sel(swap, hj, hi)
        hits[j] = _sel(swap, hi, hj)
    return hits


def _rsqrt(x):
    return jax.lax.rsqrt(jnp.maximum(x, 1e-30))


# --------------------------------------------------------------------------
# Kernel builder
# --------------------------------------------------------------------------


def _make_packer(static: SceneStatic, width: int, height: int):
    """Computes the flat parameter-vector layout for this scene structure.

    Returns (pack, off, expr_tables) where pack(packed, offset) -> flat f32
    vector, off maps slot names to offsets, and expr_tables[i] is node i's
    geometry expression with leaves rewritten to ("plane"|"sphere"|"cube",
    param_offset)."""
    entries = []  # (name, size, getter(packed, frame, aa_offset))
    off = {}

    def slot(name, size, getter):
        off[name] = sum(e[1] for e in entries)
        entries.append((name, size, getter))
        return off[name]

    # deltas shipped UNscaled and interpolated by x/width in-kernel so the
    # op sequence matches ops/camera.screen_rays exactly (pre-dividing by
    # width here shifts knife-edge pixels, e.g. the checker boundary at the
    # frame's symmetric center column)
    slot(
        "cam",
        12,
        lambda p, f, a: jnp.concatenate(
            [
                f["up_left_rel"],
                f["up_right_rel"] - f["up_left_rel"],
                f["down_left_rel"] - f["up_left_rel"],
                f["pos"],
            ]
        ),
    )
    slot("ambient", 3, lambda p, f, a: p.ambient)
    slot("aa", 2, lambda p, f, a: jnp.asarray(a, dtype=jnp.float32).reshape(2))
    # base linear pixel index of lane 0 (pack() special-cases it): the
    # in-kernel ray-gen computes lin = lin_base + pid*BLOCK + lane, so a
    # mesh shard / chunk slab owning pixels [b, b+n) traces BIT-IDENTICAL
    # rays to the full-frame kernel's lanes [b, b+n).  Shipped as f32
    # (exact: bases are block multiples, so f32 holds them exactly
    # even past 2^24) and converted to s32 in-kernel.
    slot("lin", 1, None)
    for li in range(static.n_lights):
        slot(
            f"light{li}",
            6,
            lambda p, f, a, li=li: jnp.concatenate(
                [p.light_pos[li], p.light_color[li] * p.light_power[li]]
            ),
        )

    def _expr_offsets(expr, i, counter):
        kind = expr[0]
        if kind == "csg":
            left = _expr_offsets(expr[2], i, counter)
            right = _expr_offsets(expr[3], i, counter)
            return ("csg", expr[1], left, right)
        k = counter[0]
        counter[0] += 1
        name = f"n{i}_g{k}"
        gi = expr[1]
        if kind == "plane":
            o = slot(
                name, 2, lambda p, f, a, gi=gi: jnp.stack([p.plane_y[gi], p.plane_limit[gi]])
            )
        elif kind == "sphere":
            o = slot(
                name,
                4,
                lambda p, f, a, gi=gi: jnp.concatenate([p.sphere_center[gi], p.sphere_r[gi][None]]),
            )
        else:
            o = slot(
                name,
                4,
                lambda p, f, a, gi=gi: jnp.concatenate([p.cube_center[gi], p.cube_side[gi][None]]),
            )
        return (kind, o)

    expr_tables = []
    for i, ns in enumerate(static.nodes):
        if not ns.identity_transform:
            if ns.offset_only:
                slot(f"n{i}_off", 3, lambda p, f, a, i=i: p.node_offset[i])
            else:
                # m, inv(m), offset — inverses computed in-graph so they stay
                # current with the (differentiable) matrix leaves
                slot(
                    f"n{i}_mtx",
                    21,
                    lambda p, f, a, i=i: jnp.concatenate(
                        [
                            p.node_matrix[i].reshape(-1),
                            jnp.linalg.inv(p.node_matrix[i]).reshape(-1),
                            p.node_offset[i],
                        ]
                    ),
                )
        slot(
            f"n{i}_mat",
            6,
            lambda p, f, a, i=i: jnp.concatenate(
                [p.mat_color[i], p.mat_exponent[i][None], p.mat_strength[i][None], p.mat_ior[i][None]]
            ),
        )
        if ns.tex_kind == TEX_CHECKER:
            slot(
                f"n{i}_tex",
                7,
                lambda p, f, a, i=i: jnp.concatenate(
                    [p.checker_c1[i], p.checker_c2[i], p.checker_size[i][None]]
                ),
            )
        elif ns.tex_kind == TEX_PROC2:
            slot(
                f"n{i}_tex",
                24,
                lambda p, f, a, i=i: jnp.concatenate(
                    [
                        p.proc2_color_u[i].reshape(-1),
                        p.proc2_color_v[i].reshape(-1),
                        p.proc2_freq_u[i],
                        p.proc2_freq_v[i],
                    ]
                ),
            )
        counter = [0]
        expr_tables.append(_expr_offsets(ns.geom, i, counter))

    n_prm = sum(e[1] for e in entries)

    def pack(packed: ScenePacked, aa_offset=(0.0, 0.0), lin_base=0):
        frame = begin_frame(packed.camera, width / height)
        parts = []
        for name, _, g in entries:
            if name == "lin":
                parts.append(jnp.asarray(lin_base, jnp.float32).reshape(1))
            else:
                parts.append(g(packed, frame, aa_offset))
        return jnp.concatenate([x.reshape(-1).astype(jnp.float32) for x in parts])

    return pack, off, expr_tables, n_prm


# --------------------------------------------------------------------------
# In-kernel geometry (mirrors ops/geometry.py on [BLOCK] SoA arrays)
# --------------------------------------------------------------------------


def _geom_builders(p):
    """Returns the in-kernel geometry functions, closed over the parameter
    reader ``p``.  Every expr argument is an offset-rewritten expression
    tree from _make_packer; rays are SoA scalar tiles."""

    def zeros_like(t):
        return jnp.zeros_like(t)

    # ---- leaves: closest hit ------------------------------------------

    def plane_closest(b, ox, oy, oz, dx, dy, dz, needs_uv):
        y0, limit = p(b), p(b + 1)
        miss = ((oy > y0) & (dy > -1e-9)) | ((oy < y0) & (dy < 1e-9))
        nonzero = dy != 0
        inv = jnp.where(nonzero, -1.0 / jnp.where(nonzero, dy, 1.0), 0.0)
        t = (oy - y0) * inv
        px = ox + dx * t
        pz = oz + dz * t
        ok = (~miss) & nonzero & (jnp.abs(px) <= limit) & (jnp.abs(pz) <= limit)
        z = zeros_like(t)
        # slim record: no position fields (p = o + d*t is recomputed where
        # needed) and UVs only for textured nodes — fewer live values
        # per ray means fewer registers per thread and fewer spills
        rec = dict(t=jnp.where(ok, t, INF), nx=z, ny=z + 1.0, nz=z)
        if needs_uv:
            rec["u"], rec["v"] = px, pz
        return rec

    def _sphere_roots(b, ox, oy, oz, dx, dy, dz):
        cx, cy, cz, r = p(b), p(b + 1), p(b + 2), p(b + 3)
        hx, hy, hz = ox - cx, oy - cy, oz - cz
        A = dx * dx + dy * dy + dz * dz
        B = 2.0 * (hx * dx + hy * dy + hz * dz)
        C = hx * hx + hy * hy + hz * hz - r * r
        D = B * B - 4.0 * A * C
        has = D >= 0
        sq = jnp.sqrt(jnp.where(has, D, 0.0))
        inv2a = 1.0 / (2.0 * A)
        return has, (-B + sq) * inv2a, (-B - sq) * inv2a  # x2 <= x1

    def _sphere_record(b, ox, oy, oz, dx, dy, dz, t, ok, needs_uv):
        cx, cy, cz, r = p(b), p(b + 1), p(b + 2), p(b + 3)
        ts = jnp.where(ok, t, 0.0)
        rx, ry, rz = ox + dx * ts - cx, oy + dy * ts - cy, oz + dz * ts - cz
        inv = _rsqrt(rx * rx + ry * ry + rz * rz)
        rec = dict(t=jnp.where(ok, t, INF), nx=rx * inv, ny=ry * inv, nz=rz * inv)
        if needs_uv:
            # spherical UVs (geometry.d:110-117)
            rec["u"] = (_PI + jnp.arctan2(rz, rx)) / (2 * _PI)
            rec["v"] = 1.0 - (_PI / 2 + jnp.arcsin(jnp.clip(ry / r, -1.0, 1.0))) / _PI
        return rec

    def sphere_closest(b, ox, oy, oz, dx, dy, dz, needs_uv):
        has, x1, x2 = _sphere_roots(b, ox, oy, oz, dx, dy, dz)
        sol = jnp.where(x2 < 0, x1, x2)  # nearer root unless behind (geometry.d:104-108)
        ok = has & (sol >= 0)
        return _sphere_record(b, ox, oy, oz, dx, dy, dz, sol, ok, needs_uv)

    # face order matches ops/geometry._CUBE_FACES: (axis, sign, u_axis, v_axis)
    _FACES = ((1, -1.0, 0, 2), (1, 1.0, 0, 2), (0, -1.0, 1, 2), (0, 1.0, 1, 2), (2, -1.0, 0, 1), (2, 1.0, 0, 1))

    def _cube_faces(b, ox, oy, oz, dx, dy, dz, needs_uv):
        cx, cy, cz, side = p(b), p(b + 1), p(b + 2), p(b + 3)
        half = side * 0.5
        o3, d3, c3 = (ox, oy, oz), (dx, dy, dz), (cx, cy, cz)
        cands = []
        for axis, s, ua, va in _FACES:
            dk, ok_, ck = d3[axis], o3[axis], c3[axis]
            valid = jnp.abs(dk) >= 1e-9
            inv = jnp.where(valid, -1.0 / jnp.where(valid, dk, 1.0), 0.0)
            t = (ok_ - (ck + s * half)) * inv
            pxs = [o3[k] + d3[k] * t for k in range(3)]
            oa, ob = (axis + 1) % 3, (axis + 2) % 3
            inside = (
                (pxs[oa] >= c3[oa] - half)
                & (pxs[oa] <= c3[oa] + half)
                & (pxs[ob] >= c3[ob] - half)
                & (pxs[ob] <= c3[ob] + half)
            )
            hit_ok = valid & (t >= 0) & inside
            z = zeros_like(t)
            n = [z, z, z]
            n[axis] = z + s
            rec = dict(t=jnp.where(hit_ok, t, INF), nx=n[0], ny=n[1], nz=n[2])
            if needs_uv:
                rec["u"], rec["v"] = pxs[ua] - c3[ua], pxs[va] - c3[va]
            cands.append(rec)
        return cands

    def cube_closest(b, ox, oy, oz, dx, dy, dz, needs_uv):
        cands = _cube_faces(b, ox, oy, oz, dx, dy, dz, needs_uv)
        best = cands[0]
        for c in cands[1:]:
            best = _sel(c["t"] < best["t"], c, best)
        return best

    def cube_two_hits(b, ox, oy, oz, dx, dy, dz, needs_uv):
        """The (<= 2) valid face crossings, ascending, via a running
        best/second pass (cheaper than a 6-slot sorting network)."""
        cands = _cube_faces(b, ox, oy, oz, dx, dy, dz, needs_uv)
        best, second = cands[0], cands[1]
        sw = second["t"] < best["t"]
        best, second = _sel(sw, second, best), _sel(sw, best, second)
        for c in cands[2:]:
            bb = c["t"] < best["t"]
            bs = c["t"] < second["t"]
            new_second = _sel(bb, best, _sel(bs, c, second))
            best = _sel(bb, c, best)
            second = new_second
        return [best, second]

    def cube_slab_dists(b, ox, oy, oz, dx, dy, dz):
        """Slab-method (t_enter, t_exit) — the dist-only cube test for
        shadow scans / CSG walks (mirrors ops/geometry._cube_dists)."""
        cx, cy, cz, side = p(b), p(b + 1), p(b + 2), p(b + 3)
        half = side * 0.5
        o3, d3, c3 = (ox, oy, oz), (dx, dy, dz), (cx, cy, cz)
        t_enter = None
        t_exit = None
        for axis in range(3):
            dk, ok_, ck = d3[axis], o3[axis], c3[axis]
            valid = jnp.abs(dk) >= 1e-9
            inv = 1.0 / jnp.where(valid, dk, 1.0)
            t1 = (ck - half - ok_) * inv
            t2 = (ck + half - ok_) * inv
            tn = jnp.minimum(t1, t2)
            tf = jnp.maximum(t1, t2)
            inside = (ok_ >= ck - half) & (ok_ <= ck + half)
            tn = jnp.where(valid, tn, jnp.where(inside, -INF, INF))
            tf = jnp.where(valid, tf, jnp.where(inside, INF, -INF))
            t_enter = tn if t_enter is None else jnp.maximum(t_enter, tn)
            t_exit = tf if t_exit is None else jnp.minimum(t_exit, tf)
        hit = (t_enter <= t_exit) & (t_exit >= 0)
        d1 = jnp.where(hit & (t_enter >= 0), t_enter, INF)
        d2 = jnp.where(hit, t_exit, INF)
        return [jnp.minimum(d1, d2), jnp.maximum(d1, d2)]

    # ---- inside tests (geometry.d:127-130, :165-170, :334-337) --------

    def is_inside(expr, px, py, pz):
        kind = expr[0]
        if kind == "plane":
            return jnp.zeros_like(px, dtype=jnp.bool_)
        if kind == "sphere":
            b = expr[1]
            rx, ry, rz = p(b) - px, p(b + 1) - py, p(b + 2) - pz
            return rx * rx + ry * ry + rz * rz < p(b + 3) * p(b + 3)
        if kind == "cube":
            b = expr[1]
            h = p(b + 3) * 0.5
            return (
                (jnp.abs(px - p(b)) <= h)
                & (jnp.abs(py - p(b + 1)) <= h)
                & (jnp.abs(pz - p(b + 2)) <= h)
            )
        _, op, left, right = expr
        il = is_inside(left, px, py, pz)
        ir = is_inside(right, px, py, pz)
        return _bool_op(op, il, ir)

    def _bool_op(op, il, ir):
        if op == "union":
            return il | ir
        if op == "inter":
            return il & ir
        return il & ~ir  # diff

    # ---- all-hits + CSG parity walk (mirrors all_hits_expr) -----------

    def all_hits(expr, ox, oy, oz, dx, dy, dz, needs_uv):
        kind = expr[0]
        if kind == "plane":
            return [plane_closest(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)]
        if kind == "sphere":
            has, x1, x2 = _sphere_roots(expr[1], ox, oy, oz, dx, dy, dz)
            h2 = _sphere_record(expr[1], ox, oy, oz, dx, dy, dz, x2, has & (x2 >= 0), needs_uv)
            h1 = _sphere_record(expr[1], ox, oy, oz, dx, dy, dz, x1, has & (x1 >= 0), needs_uv)
            return [h2, h1]
        if kind == "cube":
            return cube_two_hits(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)

        _, op, left, right = expr
        lh = all_hits(left, ox, oy, oz, dx, dy, dz, needs_uv)
        rh = all_hits(right, ox, oy, oz, dx, dy, dz, needs_uv)
        merged = []
        for h in lh:
            merged.append(dict(h, side=jnp.zeros_like(h["t"])))
        for h in rh:
            merged.append(dict(h, side=jnp.ones_like(h["t"])))
        _ce_sort(merged)

        # initial parity: odd hit count => started inside (geometry.d:307-309)
        def _odd(hits):
            c = None
            for h in hits:
                v = (h["t"] < INF).astype(jnp.int32)
                c = v if c is None else c + v
            return (c % 2) == 1

        in_l = _odd(lh)
        in_r = _odd(rh)
        out = []
        for h in merged:
            valid = h["t"] < INF
            from_right = h["side"] > 0.5
            in_l = in_l ^ (~from_right & valid)
            in_r = in_r ^ (from_right & valid)
            state = _bool_op(op, in_l, in_r) & valid
            h = dict(h)
            h.pop("side")
            if op == "diff":
                # CsgDiff normal flip (geometry.d:377-397): eaten-out surface.
                # Probe step 1e-3, NOT the reference's 1e-6: the kernel is
                # f32-only and 1e-6 is below one ulp at the reference scenes'
                # coordinate scale (~1e2) — p +- dir*1e-6 == p and the flip
                # would silently never fire (matches ops/geometry.py's f32
                # branch and the shadow_eps dtype split)
                ts = jnp.where(valid, h["t"], 0.0)
                hx, hy, hz = ox + dx * ts, oy + dy * ts, oz + dz * ts
                before = is_inside(right, hx - dx * 1e-3, hy - dy * 1e-3, hz - dz * 1e-3)
                after = is_inside(right, hx + dx * 1e-3, hy + dy * 1e-3, hz + dz * 1e-3)
                flip = (before != after) & state
                sgn = jnp.where(flip, -1.0, 1.0)
                h["nx"], h["ny"], h["nz"] = h["nx"] * sgn, h["ny"] * sgn, h["nz"] * sgn
            h["t"] = jnp.where(state, h["t"], INF)
            out.append(h)
        return out

    def expr_closest(expr, ox, oy, oz, dx, dy, dz, needs_uv):
        if expr[0] == "plane":
            return plane_closest(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)
        if expr[0] == "sphere":
            return sphere_closest(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)
        if expr[0] == "cube":
            return cube_closest(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)
        hits = all_hits(expr, ox, oy, oz, dx, dy, dz, needs_uv)
        best = hits[0]
        for h in hits[1:]:
            best = _sel(h["t"] < best["t"], h, best)
        return best

    # ---- dist-only variants for shadow scans --------------------------

    def dists_only(expr, ox, oy, oz, dx, dy, dz):
        """Sorted positive hit distances [list of tiles] of an expression
        (the all_hits parity walk without record fields)."""
        kind = expr[0]
        if kind == "plane":
            h = plane_closest(expr[1], ox, oy, oz, dx, dy, dz, False)
            return [h["t"]]
        if kind == "sphere":
            has, x1, x2 = _sphere_roots(expr[1], ox, oy, oz, dx, dy, dz)
            return [jnp.where(has & (x2 >= 0), x2, INF), jnp.where(has & (x1 >= 0), x1, INF)]
        if kind == "cube":
            return cube_slab_dists(expr[1], ox, oy, oz, dx, dy, dz)
        _, op, left, right = expr
        ld = dists_only(left, ox, oy, oz, dx, dy, dz)
        rd = dists_only(right, ox, oy, oz, dx, dy, dz)
        merged = [{"t": t, "side": jnp.zeros_like(t)} for t in ld]
        merged += [{"t": t, "side": jnp.ones_like(t)} for t in rd]
        _ce_sort(merged)

        def _odd(ts):
            c = None
            for t in ts:
                v = (t < INF).astype(jnp.int32)
                c = v if c is None else c + v
            return (c % 2) == 1

        in_l = _odd(ld)
        in_r = _odd(rd)
        out = []
        for h in merged:
            valid = h["t"] < INF
            from_right = h["side"] > 0.5
            in_l = in_l ^ (~from_right & valid)
            in_r = in_r ^ (from_right & valid)
            state = _bool_op(op, in_l, in_r) & valid
            out.append(jnp.where(state, h["t"], INF))
        return out

    def expr_min_dist(expr, ox, oy, oz, dx, dy, dz):
        if expr[0] == "plane":
            return plane_closest(expr[1], ox, oy, oz, dx, dy, dz, False)["t"]
        if expr[0] == "sphere":
            has, x1, x2 = _sphere_roots(expr[1], ox, oy, oz, dx, dy, dz)
            sol = jnp.where(x2 < 0, x1, x2)
            return jnp.where(has & (sol >= 0), sol, INF)
        if expr[0] == "cube":
            return cube_slab_dists(expr[1], ox, oy, oz, dx, dy, dz)[0]
        ds = dists_only(expr, ox, oy, oz, dx, dy, dz)
        best = ds[0]
        for d in ds[1:]:
            best = jnp.minimum(best, d)
        return best

    return expr_closest, expr_min_dist


def _kernel_raygen(p, off, width, height):
    """In-kernel camera ray generation (camera.d:119-147) on the pos-free
    corner deltas shipped by _make_packer.  Returns SoA (ox..oz, dx..dz)."""
    pid = pl.program_id(0)
    # lin slot = base linear pixel index of lane 0 (0 for full-frame; a
    # shard/slab offset under the mesh / chunk_pixels) — f32-exact, see
    # _make_packer.  Adding the s32 zero is bitwise-free for full frames.
    base = p(off["lin"]).astype(jnp.int32) + pid * BLOCK
    lin = base + jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    xpix = ((lin % width).astype(jnp.float32) + p(off["aa"])) / width
    ypix = ((lin // width).astype(jnp.float32) + p(off["aa"] + 1)) / height

    c = off["cam"]
    dx = p(c + 0) + p(c + 3) * xpix + p(c + 6) * ypix
    dy = p(c + 1) + p(c + 4) * xpix + p(c + 7) * ypix
    dz = p(c + 2) + p(c + 5) * xpix + p(c + 8) * ypix
    inv_len = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len
    zero = jnp.zeros_like(dx)
    ox, oy, oz = zero + p(c + 9), zero + p(c + 10), zero + p(c + 11)
    return ox, oy, oz, dx, dy, dz


def _node_builders(p, static, off, expr_tables):
    """In-kernel per-node intersection, closed over the parameter reader ``p``
    and the packer layout.  Returns (node_closest, node_min_dist,
    scene_scan); shared by the fused kernel and the probe harness."""
    expr_closest, expr_min_dist = _geom_builders(p)

    # ---- per-node closest hit with transforms (node.d:23-68) ------
    def node_closest(i, ox, oy, oz, dx, dy, dz):
        ns = static.nodes[i]
        # bump-mapped nodes need UVs too: the bump hybrid's fast forward
        # samples the derivative atlas at the kernel's saved u/v
        # (pallas_grad.build_bump_round0)
        needs_uv = ns.tex_kind != TEX_NONE or ns.bump_idx >= 0
        expr = expr_tables[i]
        if ns.identity_transform:
            return expr_closest(expr, ox, oy, oz, dx, dy, dz, needs_uv)
        if ns.offset_only:
            # translation leaves t, normals and canonic UVs untouched;
            # world p is recomputed from the world ray by the caller
            b = off[f"n{i}_off"]
            return expr_closest(expr, ox - p(b), oy - p(b + 1), oz - p(b + 2), dx, dy, dz, needs_uv)
        b = off[f"n{i}_mtx"]
        mi = [p(b + 9 + k) for k in range(9)]
        fx, fy, fz = p(b + 18), p(b + 19), p(b + 20)

        def mulr(v, M):  # row-vector times 3x3 (imported_types.d:13-20)
            return (
                v[0] * M[0] + v[1] * M[3] + v[2] * M[6],
                v[0] * M[1] + v[1] * M[4] + v[2] * M[7],
                v[0] * M[2] + v[1] * M[5] + v[2] * M[8],
            )

        def mulr_T(v, M):  # row-vector times M^T
            return (
                v[0] * M[0] + v[1] * M[1] + v[2] * M[2],
                v[0] * M[3] + v[1] * M[4] + v[2] * M[5],
                v[0] * M[6] + v[1] * M[7] + v[2] * M[8],
            )

        co = mulr((ox - fx, oy - fy, oz - fz), mi)
        cd = mulr((dx, dy, dz), mi)
        dlen = jnp.sqrt(jnp.maximum(cd[0] ** 2 + cd[1] ** 2 + cd[2] ** 2, 1e-30))
        inv_dl = 1.0 / dlen
        h = expr_closest(
            expr, co[0], co[1], co[2], cd[0] * inv_dl, cd[1] * inv_dl, cd[2] * inv_dl, needs_uv
        )
        miss = h["t"] >= INF
        # world p = orig + dir * (t / dlen) exactly (the dist rescaling
        # makes the world-ray parameterization consistent), so no p
        # round-trip through the matrix is needed
        wn = mulr_T((h["nx"], h["ny"], h["nz"]), mi)
        ninv = _rsqrt(wn[0] ** 2 + wn[1] ** 2 + wn[2] ** 2)
        out = dict(
            t=jnp.where(miss, INF, h["t"] * inv_dl),
            nx=wn[0] * ninv, ny=wn[1] * ninv, nz=wn[2] * ninv,
        )
        if needs_uv:
            out["u"], out["v"] = h["u"], h["v"]
        return out

    def node_min_dist(i, ox, oy, oz, dx, dy, dz):
        ns = static.nodes[i]
        expr = expr_tables[i]
        if ns.identity_transform:
            return expr_min_dist(expr, ox, oy, oz, dx, dy, dz)
        if ns.offset_only:
            b = off[f"n{i}_off"]
            return expr_min_dist(expr, ox - p(b), oy - p(b + 1), oz - p(b + 2), dx, dy, dz)
        b = off[f"n{i}_mtx"]
        mi = [p(b + 9 + k) for k in range(9)]
        fx, fy, fz = p(b + 18), p(b + 19), p(b + 20)
        cox = (ox - fx) * mi[0] + (oy - fy) * mi[3] + (oz - fz) * mi[6]
        coy = (ox - fx) * mi[1] + (oy - fy) * mi[4] + (oz - fz) * mi[7]
        coz = (ox - fx) * mi[2] + (oy - fy) * mi[5] + (oz - fz) * mi[8]
        cdx = dx * mi[0] + dy * mi[3] + dz * mi[6]
        cdy = dx * mi[1] + dy * mi[4] + dz * mi[7]
        cdz = dx * mi[2] + dy * mi[5] + dz * mi[8]
        dlen = jnp.sqrt(jnp.maximum(cdx * cdx + cdy * cdy + cdz * cdz, 1e-30))
        inv_dl = 1.0 / dlen
        d = expr_min_dist(expr, cox, coy, coz, cdx * inv_dl, cdy * inv_dl, cdz * inv_dl)
        return jnp.where(d >= INF, INF, d * inv_dl)

    any_uv = any(ns.tex_kind != TEX_NONE or ns.bump_idx >= 0 for ns in static.nodes)

    def scene_scan(ox, oy, oz, dx, dy, dz):
        best = None
        win = jnp.full(BLOCK, -1, dtype=jnp.int32)
        for i in range(len(static.nodes)):
            cand = node_closest(i, ox, oy, oz, dx, dy, dz)
            if any_uv and "u" not in cand:
                cand["u"] = cand["v"] = jnp.zeros(BLOCK, jnp.float32)
            if best is None:
                best = cand
                win = jnp.where(cand["t"] < INF, i, win)
            else:
                better = cand["t"] <= best["t"]  # ties: later node (renderer.d:336-338)
                win = jnp.where(better & (cand["t"] < INF), i, win)
                best = _sel(better, cand, best)
        return best, win

    return node_closest, node_min_dist, scene_scan


def build_round0_kernel(
    static: SceneStatic,
    width: int,
    height: int,
    interpret: bool = False,
    n_rays: int = None,
    want_hit: bool = False,
    want_vis: bool = False,
    lin_input: bool = False,
):
    """Returns fn(packed, aa_offset) -> dict of flat [N] arrays:
    color [N], win [N] (int32, -1 = miss), and — when the scene needs
    them — lightsum, u, v, refl_orig, refl_dir components.

    The function executes ONE fused pallas_call: ray-gen, closest-hit over
    every node (CSG + transforms in-kernel), per-light shadow scans, and
    direct Lambert/Phong shading with in-kernel checker/procedure2
    texturing.  Bitmap texels and bounce continuations are left for XLA
    (see render_flagship).

    With ``n_rays`` set, ray-gen is skipped and the kernel traces caller
    rays instead: fn(packed, orig3, dir3) with six flat [n_rays] arrays —
    the BOUNCE-round kernel (continuation rays re-enter the same fused
    machinery at compacted width).

    ``want_hit`` adds raw hit-record outputs — t, the (pre-faceforward)
    normal, the in-kernel diffuse texture color, and the light sum — for
    callers that do their own shading math (the GI path tracer samples
    BRDF continuations in XLA from these).

    ``want_vis`` adds one f32 0/1 output per light: the shadow-visibility
    bit.  Together with win/t/normal these are exactly the discrete
    residuals the custom-VJP backward (ops/pallas_grad.py) needs to
    reconstruct the kernel's math differentiably without re-running any
    scene scan.

    ``lin_input`` (requires ``n_rays``): the kernel ray-gens IN-KERNEL for
    the contiguous pixel slice [lin_base, lin_base + n_rays) —
    fn(packed, lin_base, aa_offset) with a traced scalar base.  Per-lane
    math is bit-identical to the full-frame kernel's lanes at the same
    linear index: the mesh-shard / chunk-slab ray-gen mode."""
    assert _supports_scene(static)
    assert not (lin_input and n_rays is None), "lin_input needs n_rays"
    ray_input = n_rays is not None and not lin_input
    n = n_rays if n_rays is not None else width * height
    n_pad = -(-n // BLOCK) * BLOCK
    grid = (n_pad // BLOCK,)

    pack, off, expr_tables, n_prm = _make_packer(static, width, height)

    has_bitmap = TEX_BITMAP in static.tex_kinds_present
    has_refl = REFLECTION in static.shader_kinds_present
    has_refr = REFRACTION in static.shader_kinds_present
    has_cont = has_refl or has_refr
    has_phong = PHONG in static.shader_kinds_present
    emit_L = has_bitmap or want_hit

    def kernel(prm_ref, *refs):
        if ray_input:
            rox_ref, roy_ref, roz_ref, rdx_ref, rdy_ref, rdz_ref = refs[:6]
            outs = refs[6:]
        else:
            outs = refs
        it = iter(outs)
        out_r, out_g, out_b = next(it), next(it), next(it)
        out_win = next(it)
        if emit_L:
            out_lr, out_lg, out_lb = next(it), next(it), next(it)
            out_u, out_v = next(it), next(it)
        if has_cont:
            out_rox, out_roy, out_roz = next(it), next(it), next(it)
            out_rdx, out_rdy, out_rdz = next(it), next(it), next(it)
        if want_hit:
            out_t = next(it)
            out_nx, out_ny, out_nz = next(it), next(it), next(it)
            out_dr, out_dg, out_db = next(it), next(it), next(it)
        if want_vis:
            out_vis = [next(it) for _ in range(static.n_lights)]

        def p(k):
            return prm_ref[k]

        if ray_input:
            ox, oy, oz = rox_ref[...], roy_ref[...], roz_ref[...]
            dx, dy, dz = rdx_ref[...], rdy_ref[...], rdz_ref[...]
        else:
            ox, oy, oz, dx, dy, dz = _kernel_raygen(p, off, width, height)

        node_closest, node_min_dist, scene_scan = _node_builders(
            p, static, off, expr_tables
        )

        hit, win = scene_scan(ox, oy, oz, dx, dy, dz)
        hitmask = win >= 0
        # world hit point recomputed once from the winning t (records are
        # position-free; dead lanes use t=0 to stay finite)
        ts = jnp.where(hitmask, hit["t"], 0.0)
        hpx, hpy, hpz = ox + dx * ts, oy + dy * ts, oz + dz * ts

        # faceforward (imported_types.d:69-73)
        ndotd = dx * hit["nx"] + dy * hit["ny"] + dz * hit["nz"]
        sgn = jnp.where(ndotd < 0, 1.0, -1.0)
        nx, ny, nz = hit["nx"] * sgn, hit["ny"] * sgn, hit["nz"] * sgn

        # ---- per-node diffuse/material select by win id ---------------
        dr = jnp.zeros(BLOCK, jnp.float32)
        dg = jnp.zeros(BLOCK, jnp.float32)
        db = jnp.zeros(BLOCK, jnp.float32)
        exp_t = jnp.ones(BLOCK, jnp.float32)
        str_t = jnp.zeros(BLOCK, jnp.float32)
        is_phong = jnp.zeros(BLOCK, jnp.bool_)
        is_direct = jnp.zeros(BLOCK, jnp.bool_)
        for i, ns in enumerate(static.nodes):
            m = win == i
            bm = off[f"n{i}_mat"]
            if ns.tex_kind == TEX_CHECKER:
                bt = off[f"n{i}_tex"]
                size = p(bt + 6)
                cxi = jnp.floor(hit["u"] / size).astype(jnp.int32)
                cyi = jnp.floor(hit["v"] / size).astype(jnp.int32)
                white = ((cxi + cyi) & 1).astype(jnp.bool_)
                cr = jnp.where(white, p(bt + 3), p(bt + 0))
                cg = jnp.where(white, p(bt + 4), p(bt + 1))
                cb = jnp.where(white, p(bt + 5), p(bt + 2))
            elif ns.tex_kind == TEX_PROC2:
                bt = off[f"n{i}_tex"]
                cr = jnp.zeros(BLOCK, jnp.float32)
                cg = jnp.zeros(BLOCK, jnp.float32)
                cb = jnp.zeros(BLOCK, jnp.float32)
                for band in range(3):
                    su = jnp.sin(hit["u"] * p(bt + 18 + band))
                    sv = jnp.sin(hit["v"] * p(bt + 21 + band))
                    cr += p(bt + band * 3 + 0) * su + p(bt + 9 + band * 3 + 0) * sv
                    cg += p(bt + band * 3 + 1) * su + p(bt + 9 + band * 3 + 1) * sv
                    cb += p(bt + band * 3 + 2) * su + p(bt + 9 + band * 3 + 2) * sv
            elif ns.tex_kind == TEX_BITMAP:
                cr = cg = cb = jnp.zeros(BLOCK, jnp.float32)  # deferred to XLA
            else:
                cr = jnp.full(BLOCK, p(bm + 0))
                cg = jnp.full(BLOCK, p(bm + 1))
                cb = jnp.full(BLOCK, p(bm + 2))
            dr = jnp.where(m, cr, dr)
            dg = jnp.where(m, cg, dg)
            db = jnp.where(m, cb, db)
            exp_t = jnp.where(m, p(bm + 3), exp_t)
            str_t = jnp.where(m, p(bm + 4), str_t)
            if ns.shader_kind == PHONG:
                is_phong = is_phong | m
            if ns.shader_kind in (LAMBERT, PHONG):
                is_direct = is_direct | m

        # ---- direct lighting with in-kernel shadow scans --------------
        amb = off["ambient"]
        lr = jnp.full(BLOCK, p(amb))
        lg = jnp.full(BLOCK, p(amb + 1))
        lb = jnp.full(BLOCK, p(amb + 2))
        sr = jnp.zeros(BLOCK, jnp.float32)
        sg = jnp.zeros(BLOCK, jnp.float32)
        sb = jnp.zeros(BLOCK, jnp.float32)
        sx = hpx + nx * EPS_SHADOW
        sy = hpy + ny * EPS_SHADOW
        sz = hpz + nz * EPS_SHADOW
        for li in range(static.n_lights):
            lbase = off[f"light{li}"]
            lx, ly, lz = p(lbase), p(lbase + 1), p(lbase + 2)
            tlx, tly, tlz = lx - hpx, ly - hpy, lz - hpz
            dist2 = tlx * tlx + tly * tly + tlz * tlz
            inv_l = _rsqrt(dist2)
            ldx, ldy, ldz = tlx * inv_l, tly * inv_l, tlz * inv_l
            # shadow scan (scene.d:62-78): any node with dist <= |to - from|
            tx2, ty2, tz2 = lx - sx, ly - sy, lz - sz
            target = jnp.sqrt(jnp.maximum(tx2 * tx2 + ty2 * ty2 + tz2 * tz2, 1e-30))
            inv_t = 1.0 / target
            sdx, sdy, sdz = tx2 * inv_t, ty2 * inv_t, tz2 * inv_t
            occ = jnp.zeros(BLOCK, jnp.bool_)
            for i in range(len(static.nodes)):
                occ = occ | (node_min_dist(i, sx, sy, sz, sdx, sdy, sdz) <= target)
            vis = ~occ
            if want_vis:
                out_vis[li][...] = jnp.where(vis, 1.0, 0.0)
            cos_t = ldx * nx + ldy * ny + ldz * nz
            gate = vis & (cos_t > 0)
            w = jnp.where(gate, cos_t / dist2, 0.0)
            lr += p(lbase + 3) * w
            lg += p(lbase + 4) * w
            lb += p(lbase + 5) * w
            if has_phong:
                # R = reflect(-lightDir, N); cosGamma = R . -d (shader.d:226-249)
                mdotn = (-ldx) * nx + (-ldy) * ny + (-ldz) * nz
                rx = -ldx - 2.0 * mdotn * nx
                ry = -ldy - 2.0 * mdotn * ny
                rz = -ldz - 2.0 * mdotn * nz
                inv_r = _rsqrt(rx * rx + ry * ry + rz * rz)
                cos_g = (rx * (-dx) + ry * (-dy) + rz * (-dz)) * inv_r
                sgate = vis & (cos_g > 0)
                spec_w = jnp.where(
                    sgate, jnp.power(jnp.maximum(cos_g, 0.0), exp_t) * str_t / dist2, 0.0
                )
                sr += p(lbase + 3) * spec_w
                sg += p(lbase + 4) * spec_w
                sb += p(lbase + 5) * spec_w

        outr = dr * lr
        outg = dg * lg
        outb = db * lb
        if has_phong:
            outr += jnp.where(is_phong, sr, 0.0)
            outg += jnp.where(is_phong, sg, 0.0)
            outb += jnp.where(is_phong, sb, 0.0)

        shaded = hitmask & is_direct
        out_r[...] = jnp.where(shaded, outr, 0.0)
        out_g[...] = jnp.where(shaded, outg, 0.0)
        out_b[...] = jnp.where(shaded, outb, 0.0)
        out_win[...] = win
        if emit_L:
            out_lr[...] = jnp.where(shaded, lr, 0.0)
            out_lg[...] = jnp.where(shaded, lg, 0.0)
            out_lb[...] = jnp.where(shaded, lb, 0.0)
            # untextured scenes carry no UVs (want_hit can still ask)
            out_u[...] = hit.get("u", jnp.zeros(BLOCK, jnp.float32))
            out_v[...] = hit.get("v", jnp.zeros(BLOCK, jnp.float32))
        if want_hit:
            out_t[...] = hit["t"]
            out_nx[...] = hit["nx"]
            out_ny[...] = hit["ny"]
            out_nz[...] = hit["nz"]
            out_dr[...] = dr
            out_dg[...] = dg
            out_db[...] = db
        if has_cont:
            # mirror continuation (render/pipeline._whitted_round)
            ddn = dx * nx + dy * ny + dz * nz
            rdx = dx - 2.0 * ddn * nx
            rdy = dy - 2.0 * ddn * ny
            rdz = dz - 2.0 * ddn * nz
            rinv = _rsqrt(rdx * rdx + rdy * rdy + rdz * rdz)
            cdx, cdy, cdz = rdx * rinv, rdy * rinv, rdz * rinv
            cox, coy, coz = sx, sy, sz
            if has_refr:
                # single-sided refraction with TIR fallback, on the RAW
                # (pre-faceforward) normal like _whitted_round
                rnx, rny, rnz = hit["nx"], hit["ny"], hit["nz"]
                ior = jnp.full(BLOCK, 1.33, jnp.float32)
                is_refr = jnp.zeros(BLOCK, jnp.bool_)
                for i, ns in enumerate(static.nodes):
                    if ns.shader_kind == REFRACTION:
                        m = win == i
                        ior = jnp.where(m, p(off[f"n{i}_mat"] + 5), ior)
                        is_refr = is_refr | m
                cos_in = -(dx * rnx + dy * rny + dz * rnz)
                entering = cos_in > 0
                eta = jnp.where(entering, 1.0 / ior, ior)
                fsgn = jnp.where(entering, 1.0, -1.0)
                nfx, nfy, nfz = rnx * fsgn, rny * fsgn, rnz * fsgn
                ci = jnp.abs(cos_in)
                kk = 1.0 - eta * eta * (1.0 - ci * ci)
                tir = kk < 0
                coef = eta * ci - jnp.sqrt(jnp.maximum(kk, 0.0))
                fx_ = eta * dx + coef * nfx
                fy_ = eta * dy + coef * nfy
                fz_ = eta * dz + coef * nfz
                finv = _rsqrt(fx_ * fx_ + fy_ * fy_ + fz_ * fz_)
                rfdx = jnp.where(tir, cdx, fx_ * finv)
                rfdy = jnp.where(tir, cdy, fy_ * finv)
                rfdz = jnp.where(tir, cdz, fz_ * finv)
                rfox = jnp.where(tir, hpx + nfx * EPS_SHADOW, hpx - nfx * EPS_SHADOW)
                rfoy = jnp.where(tir, hpy + nfy * EPS_SHADOW, hpy - nfy * EPS_SHADOW)
                rfoz = jnp.where(tir, hpz + nfz * EPS_SHADOW, hpz - nfz * EPS_SHADOW)
                cdx = jnp.where(is_refr, rfdx, cdx)
                cdy = jnp.where(is_refr, rfdy, cdy)
                cdz = jnp.where(is_refr, rfdz, cdz)
                cox = jnp.where(is_refr, rfox, cox)
                coy = jnp.where(is_refr, rfoy, coy)
                coz = jnp.where(is_refr, rfoz, coz)
            out_rdx[...] = cdx
            out_rdy[...] = cdy
            out_rdz[...] = cdz
            out_rox[...] = cox
            out_roy[...] = coy
            out_roz[...] = coz

    names = ["r", "g", "b", "win"]
    dtypes = [jnp.float32] * 3 + [jnp.int32]
    if emit_L:
        names += ["lr", "lg", "lb", "u", "v"]
        dtypes += [jnp.float32] * 5
    if has_cont:
        names += ["rox", "roy", "roz", "rdx", "rdy", "rdz"]
        dtypes += [jnp.float32] * 6
    if want_hit:
        names += ["t", "nx", "ny", "nz", "dr", "dg", "db"]
        dtypes += [jnp.float32] * 7
    if want_vis:
        names += [f"vis{li}" for li in range(static.n_lights)]
        dtypes += [jnp.float32] * static.n_lights

    out_specs = [pl.BlockSpec((BLOCK,), lambda i: (i,)) for _ in names]
    out_shape = [jax.ShapeDtypeStruct((n_pad,), dt) for dt in dtypes]
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    # the parameter vector rides whole into every program; Triton wants
    # power-of-two array extents
    prm_pad = 1 << max(0, (n_prm - 1).bit_length())
    prm_spec = pl.BlockSpec((prm_pad,), lambda i: (0,))

    def call(prm, *rays):
        prm = jnp.pad(prm, (0, prm_pad - n_prm))
        outs = pl.pallas_call(
            kernel,
            grid=grid,
            in_specs=[prm_spec] + [ray_spec] * len(rays),
            out_specs=out_specs,
            out_shape=out_shape,
            backend="triton",
            compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
            interpret=interpret,
            name="fused_round0",
        )(prm, *rays)
        return {k: o[:n] for k, o in zip(names, outs)}

    def _pad_rays(a, fill=0.0):
        return jnp.pad(a, (0, n_pad - n), constant_values=fill)

    if ray_input:

        def run(packed: ScenePacked, orig, dir, aa_offset=(0.0, 0.0)):
            # padding lanes get unit-z directions: zero dirs would exercise
            # the guarded-reciprocal edge cases for nothing
            rays = [_pad_rays(orig[:, k]) for k in range(3)] + [
                _pad_rays(dir[:, k], fill=float(k == 2)) for k in range(3)
            ]
            return call(pack(packed, aa_offset), *rays)

    elif lin_input:

        def run(packed: ScenePacked, lin_base, aa_offset=(0.0, 0.0)):
            return call(pack(packed, aa_offset, lin_base))

    else:

        def run(packed: ScenePacked, aa_offset=(0.0, 0.0)):
            return call(pack(packed, aa_offset))

    return run


# --------------------------------------------------------------------------
# XLA-side combine: deferred bitmap texels, env misses, bounce rounds
# --------------------------------------------------------------------------


def _reused_quads(static, quads, key, texel_reuse):
    """AA-tap texel-gather dedupe: given the
    base tap's (key0, g0 [n, 12]) in ``texel_reuse``, return this tap's
    quads by reusing g0 where the texel key is unchanged (the overwhelming
    majority — sub-pixel offsets <= 0.6 px) and re-gathering only the
    changed lanes, LANE-compacted: one n-key sort + one [cap, 12] row
    gather + one [cap, 12] sorted scatter-set, vs a full per-index gather.
    Same keys -> same rows, so the result is
    bit-identical; overflow falls back to the full gather (lax.cond).
    Differentiable: unchanged lanes route their cotangents into the base
    tap's gather (linear), changed lanes into the small one."""
    from ..render import pipeline as P
    from . import shade as S

    key0, g0 = texel_reuse
    n = key.shape[0]
    cap = static.texel_reuse_capacity or -(-n // 8)
    cap = min(cap, n)
    changed = key != key0
    count = changed.sum()

    def full(_):
        return S.quad_gather_flat(quads, key)

    def compact(g0):
        sel = P.compact_indices(changed, n, cap)
        selc = jnp.minimum(sel, n - 1)
        live = jnp.arange(cap) < count
        rows = S.quad_gather_flat(quads, key[selc])
        tgt = jnp.where(live, sel, n)
        return g0.at[tgt].set(rows, mode="drop", indices_are_sorted=True)

    return jax.lax.cond(count <= cap, compact, full, g0)


def combine_outputs(packed: ScenePacked, static: SceneStatic, o, dirs_or_none,
                    texel_plan=False, texel_reuse=None):
    """Kernel outputs -> (direct color incl. deferred texels + env,
    continuation mask, attenuation factor, refl orig, refl dir).

    Every op here is differentiable; the grad path (ops/pallas_grad.py)
    shares this combine so bitmap-texel / env / attenuation cotangents are
    identical to the forward flagship's structure.

    ``texel_plan=True`` appends (key, g) — this tap's texel keys and
    gathered [n, 12] quads — to the returned tuple, for AA-tap reuse;
    ``texel_reuse=(key0, g0)`` consumes a base tap's plan (_reused_quads)."""
    from . import shade as S

    has_bitmap = TEX_BITMAP in static.tex_kinds_present
    has_refl = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    use_env = static.has_env and dirs_or_none is not None
    win = o["win"]
    color = jnp.stack([o["r"], o["g"], o["b"]], axis=-1)
    winc = jnp.maximum(win, 0)
    onehot = S.node_onehot(static, winc) if (has_bitmap or has_refl) else None
    plan = None
    if has_bitmap and use_env:
        # MERGED per-ray row gather: bitmap-hit texels and miss-ray cubemap
        # texels are mutually exclusive, so one gather over the
        # concatenated quad tables serves both, one index per ray instead
        # of two for bitmap+skybox scenes like zaphod (BASELINE config #4)
        from .env import cubemap_plan, cubemap_quads

        quads_t, key_t, p_t, q_t = S.bitmap_plan(packed, static, winc, o["u"], o["v"], onehot)
        quads_e = cubemap_quads(packed.env_cubemap)
        key_e, p_e, q_e = cubemap_plan(packed.env_cubemap, dirs_or_none)
        miss = win < 0
        missc = miss[..., None]
        key = jnp.where(miss, quads_t.shape[0] + key_e, key_t)
        quads_all = jnp.concatenate([quads_t, quads_e])
        if texel_reuse is not None:
            g = _reused_quads(static, quads_all, key, texel_reuse)
        else:
            g = S.quad_gather_flat(quads_all, key)
        plan = (key, g)
        out3 = S.bilerp_quad(g, jnp.where(missc, p_e, p_t), jnp.where(missc, q_e, q_t))
        L = jnp.stack([o["lr"], o["lg"], o["lb"]], axis=-1)
        is_bmp = (S.tex_kind_of(static, winc) == TEX_BITMAP) & (win >= 0)
        w3 = jnp.where(is_bmp[..., None], L, 0.0) + jnp.where(missc, 1.0, 0.0)
        color = color + out3 * w3
    elif has_bitmap:
        if texel_plan or texel_reuse is not None:
            quads_t, key_t, p_t, q_t = S.bitmap_plan(
                packed, static, winc, o["u"], o["v"], onehot
            )
            if texel_reuse is not None:
                g = _reused_quads(static, quads_t, key_t, texel_reuse)
            else:
                g = S.quad_gather_flat(quads_t, key_t)
            plan = (key_t, g)
            tex = S.bilerp_quad(g, p_t, q_t)
        else:
            tex = S.bitmap_color(packed, static, winc, o["u"], o["v"], onehot)
        L = jnp.stack([o["lr"], o["lg"], o["lb"]], axis=-1)
        is_bmp = (S.tex_kind_of(static, winc) == TEX_BITMAP) & (win >= 0)
        color = color + jnp.where(is_bmp[..., None], tex * L, 0.0)
    elif use_env:
        from .env import sample_cubemap

        env = sample_cubemap(packed.env_cubemap, dirs_or_none)
        color = color + jnp.where((win < 0)[..., None], env, 0.0)
    if not has_refl:
        out = (color, None, None, None, None)
    else:
        skind = S.shader_kind_of(static, winc)
        cont = (win >= 0) & ((skind == REFLECTION) | (skind == REFRACTION))
        atten = jnp.where(cont[..., None], S.node_gather(onehot, packed.mat_color), 1.0)
        ro = jnp.stack([o["rox"], o["roy"], o["roz"]], axis=-1)
        rd = jnp.stack([o["rdx"], o["rdy"], o["rdz"]], axis=-1)
        out = (color, cont, atten, ro, rd)
    if texel_plan:
        return out + (plan,)
    return out


def build_bounce_finisher(
    static: SceneStatic,
    width: int,
    height: int,
    interpret: bool,
    n_lanes: int,
    is_slab: bool = False,
):
    """Reflection/refraction bounce rounds for an ``n_lanes``-wide ray
    buffer: returns ``finish(packed, color, cont, atten, ro, rd)``.
    Factored out of build_flagship_renderer so the chunked renderer can
    instantiate the identical machinery (block/lane/full-width modes,
    capacity fallbacks) at slab width.

    ``is_slab``: True when ``n_lanes`` is a chunk_pixels slab rather than
    the whole frame — the default block capacity budgets a larger share
    (slab/4 vs frame/12), because the frame's whole reflective set can
    land inside one slab (measured: the frame-share default overflowed on
    8K slabs and silently fell back to full-width XLA rounds, 2.46 s vs
    1.09 s/frame)."""
    from ..render import pipeline as P
    from .pallas_grad import build_trace_round0

    has_refl = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    rounds = (static.max_trace_depth + 1) if has_refl else 1
    n = n_lanes  # the moved bodies below read ``n`` unchanged

    def combine(packed, o, dirs_or_none):
        return combine_outputs(packed, static, o, dirs_or_none)

    # bounce rounds re-enter the fused kernel at compacted width (rounded
    # up to whole kernel tiles) — or at FULL width (bounce_mode="full"),
    # which skips the sort/gather/scatter compaction machinery entirely
    # and relies on the all-dead cond-skip: the better choice when rounds
    # 2+ are all-dead and the compaction fixed cost exceeds one
    # full-width kernel+combine round
    cap = static.bounce_capacity
    full_bounce = has_refl and static.bounce_mode == "full"
    # BLOCK-granular compaction: the continuation set is spatially
    # clustered (reflective objects are compact on screen), so compacting
    # whole blocks keeps the bookkeeping small: the compaction sort runs
    # over n/128 block keys (not n lanes) and the writeback is cap_blk
    # unique block-row adds (not a lane scatter).  Block mode keeps
    # "full"'s cheap bookkeeping AND "compact"'s small combine.
    block_bounce = (
        has_refl and static.bounce_mode == "block" and n % BOUNCE_BLOCK == 0
    )
    use_pallas_bounce = (
        has_refl and cap and cap < n and not full_bounce and not block_bounce
    )
    if use_pallas_bounce:
        cap = -(-cap // BLOCK) * BLOCK
        kern_bounce = build_trace_round0(static, width, height, interpret, n_rays=cap)
    if full_bounce or block_bounce or use_pallas_bounce:
        # full-width ray-input kernel: the "full" mode's round driver AND
        # the capacity-overflow fallback of the compacted modes.  The old
        # fallback (P.continue_bounces -> lax.scan over XLA rounds) stacked
        # [rounds, N, 3] scan residuals under reverse-mode AD, allocated
        # even when the branch never executes (XLA sizes a cond by the max
        # over branches).  Unrolled kernel rounds keep residuals per-round,
        # and are bit-identical to "full" mode.
        kern_fullw = build_trace_round0(static, width, height, interpret, n_rays=n)
    if block_bounce:
        nblk = n // BOUNCE_BLOCK
        lanes_per_tile = BLOCK // BOUNCE_BLOCK  # cap_blk granularity
        if static.bounce_block_capacity:
            cap_blk = static.bounce_block_capacity
        else:
            # ~1/12 of the FRAME's blocks (flagship needs 6.1%); overflow
            # falls back to full-width rounds, never to wrong pixels.
            # Chunked slabs concentrate the frame's reflective set, so
            # they budget 1/4 of the SLAB's blocks — the measured 8K
            # ladder: slab/12 overflowed (2.46 s/frame via the XLA
            # fallback), slab/4 hit 1.09 s, a full-slab cap paid 1.81 s
            # for unused width.
            cap_blk = -(-nblk // (4 if is_slab else 12))
        cap_blk = max(lanes_per_tile, -(-cap_blk // lanes_per_tile) * lanes_per_tile)
        kern_blk = build_trace_round0(
            static, width, height, interpret, n_rays=cap_blk * BOUNCE_BLOCK
        )


    def pallas_bounces(packed, color, atten0, alive, orig, dir, n_rounds):
        """Compact the continuation set, then run each remaining round
        through the ray-input kernel — the XLA node scans were the last
        expensive piece of the combine.  Overflow falls back to the XLA
        full-width rounds (correctness never depends on the bound)."""
        count = alive.sum()

        def full_path(color, atten, alive, orig, dir):
            # overflow fallback = the full-width KERNEL rounds (see the
            # kern_fullw build note: the XLA-scan fallback's stacked AD
            # residuals OOM'd the 1080p grad step).  jax.checkpoint: the
            # unrolled rounds would otherwise save ~[N, 3] residuals per
            # round, several of which XLA lays out as T(8, 128) (43x pad)
            # — and a cond allocates its untaken branch too.  Saving only
            # the 5 inputs keeps the rarely-taken branch memory-flat.
            # inputs saved TRANSPOSED [3, N]: checkpoint materializes its
            # residuals, and XLA lays a saved [N, 3] out as T(8, 128)
            # (43x pad -> 1 GB each at 1080p); [3, N] pads ~nothing
            return jax.checkpoint(
                lambda cT, atT, al, oT, dT: fullwidth_bounces(
                    packed, cT.T, atT.T, al, oT.T, dT.T, n_rounds
                )
            )(color.T, atten.T, alive, orig.T, dir.T)

        def compact_path(color, atten, alive, orig, dir):
            sel = P.compact_indices(alive, n, cap)  # one lax.sort
            lane_live = jnp.arange(cap) < count
            def one_round(carry):
                sub_color, at, a, o3, d3 = carry
                o = kern_bounce(packed, o3, d3)
                c, cont, mult, ro, rd = combine(packed, o, d3 if static.has_env else None)
                sub_color = sub_color + jnp.where(a[..., None], at * c, 0.0)
                cont = cont & a
                at = at * jnp.where(cont[..., None], mult, 1.0)
                o3 = jnp.where(cont[..., None], ro, o3)
                d3 = jnp.where(cont[..., None], rd, d3)
                return sub_color, at, cont, o3, d3

            # ONE merged row gather instead of three
            g = jnp.concatenate([atten, orig, dir], axis=-1)[sel]  # junk slots clamp
            carry = (
                jnp.zeros((cap, 3), dtype=color.dtype),
                g[:, 0:3],
                lane_live,
                g[:, 3:6],
                g[:, 6:9],
            )
            for _ in range(n_rounds):
                # skip all-dead rounds at runtime (a cond executes one branch)
                carry = jax.lax.cond(carry[2].any(), one_round, lambda c: c, carry)
            sub_color = carry[0]
            # sorted monotone scatter-add: junk slots drop out of range
            # (see pipeline.continue_bounces for the rationale)
            tgt = jnp.where(lane_live, sel, n)
            return color.at[tgt].add(sub_color, mode="drop", indices_are_sorted=True)

        return jax.lax.cond(count <= cap, compact_path, full_path, color, atten0, alive, orig, dir)

    def block_bounces(packed, color, atten0, alive, orig, dir, n_rounds):
        """Bounce rounds on a BLOCK-compacted buffer: whole 128-lane blocks
        with any live lane are gathered into cap_blk block slots, rounds
        run at cap_blk*128 width through the ray-input kernel, and results
        scatter back as cap_blk unique block-row adds.  The compaction
        sort touches n/128 keys instead of n — all three lane-granular
        fixed costs (2M sort, 129k-row gather, 129k-row scatter-add)
        collapse to block-count-sized ones.  Every step (cond, row gather,
        scatter-add) is reverse-differentiable."""
        B = BOUNCE_BLOCK
        blk_alive = alive.reshape(nblk, B).any(axis=1)
        count = blk_alive.sum()

        def full_path(color, atten, alive, orig, dir):
            # kernel-based REMATED overflow fallback (see pallas_bounces'
            # full_path note)
            # transposed-input remat: see pallas_bounces' full_path note
            return jax.checkpoint(
                lambda cT, atT, al, oT, dT: fullwidth_bounces(
                    packed, cT.T, atT.T, al, oT.T, dT.T, n_rounds
                )
            )(color.T, atten.T, alive, orig.T, dir.T)

        def compact_path(color, atten, alive, orig, dir):
            sel = P.compact_indices(blk_alive, nblk, cap_blk)  # sort over n/B keys
            blk_live = jnp.arange(cap_blk) < count
            lane_blk_live = jnp.broadcast_to(blk_live[:, None], (cap_blk, B)).reshape(-1)
            # Slab gathers on [nblk, B, ...] views: splitting the MAJOR
            # axis is a free view (physical layout unchanged), so each
            # gather moves contiguous (1, B, 3) slabs — row-granular.
            selc = jnp.minimum(sel, nblk - 1)  # sentinel clamps; masks kill junk

            def slab(x):
                return jnp.take(x.reshape((nblk, B) + x.shape[1:]), selc, axis=0)

            at = slab(atten).reshape(cap_blk * B, 3)
            o3 = slab(orig).reshape(cap_blk * B, 3)
            d3 = slab(dir).reshape(cap_blk * B, 3)
            a = slab(alive).reshape(cap_blk * B) & lane_blk_live

            def one_round(carry):
                sub_color, at, a, o3, d3 = carry
                o = kern_blk(packed, o3, d3)
                c, cont, mult, ro, rd = combine(packed, o, d3 if static.has_env else None)
                sub_color = sub_color + jnp.where(a[..., None], at * c, 0.0)
                cont = cont & a
                at = at * jnp.where(cont[..., None], mult, 1.0)
                o3 = jnp.where(cont[..., None], ro, o3)
                d3 = jnp.where(cont[..., None], rd, d3)
                return sub_color, at, cont, o3, d3

            carry = (jnp.zeros((cap_blk * B, 3), dtype=color.dtype), at, a, o3, d3)
            for _ in range(n_rounds):
                carry = jax.lax.cond(carry[2].any(), one_round, lambda c: c, carry)
            # slab scatter-add: cap_blk unique sorted (1, B, 3) updates
            sub = carry[0].reshape(cap_blk, B, 3)
            tgt = jnp.where(blk_live, sel, nblk)
            # NB: no unique_indices promise — junk slots all hold the same
            # out-of-range sentinel, and XLA only documents drop-before-
            # write as an implementation detail (see continue_bounces)
            return (
                color.reshape(nblk, B, 3)
                .at[tgt]
                .add(sub, mode="drop", indices_are_sorted=True)
                .reshape(n, 3)
            )

        return jax.lax.cond(count <= cap_blk, compact_path, full_path, color, atten0, alive, orig, dir)

    def fullwidth_bounces(packed, color, atten, alive, orig, dir, n_rounds):
        """Bounce rounds at full frame width through the ray-input kernel:
        no compaction at all — each live round costs one kernel launch +
        one combine; all-dead rounds cost nothing (cond-skip)."""

        def one_round(carry):
            color, at, a, o3, d3 = carry
            o = kern_fullw(packed, o3, d3)
            c, cont, mult, ro, rd = combine(packed, o, d3 if static.has_env else None)
            color = color + jnp.where(a[..., None], at * c, 0.0)
            cont = cont & a
            at = at * jnp.where(cont[..., None], mult, 1.0)
            o3 = jnp.where(cont[..., None], ro, o3)
            d3 = jnp.where(cont[..., None], rd, d3)
            return color, at, cont, o3, d3

        carry = (color, atten, alive, orig, dir)
        for _ in range(n_rounds):
            carry = jax.lax.cond(carry[2].any(), one_round, lambda c: c, carry)
        return carry[0]

    def _finish_bounces(packed, color, cont, atten, ro, rd):
        if not has_refl:
            return color
        if full_bounce:
            return fullwidth_bounces(packed, color, atten, cont, ro, rd, rounds - 1)
        if block_bounce:
            return block_bounces(packed, color, atten, cont, ro, rd, rounds - 1)
        if use_pallas_bounce:
            return pallas_bounces(packed, color, atten, cont, ro, rd, rounds - 1)
        return P.continue_bounces(packed, static, color, atten, cont, ro, rd, rounds - 1)

    return _finish_bounces


def build_flagship_renderer(static: SceneStatic, width: int, height: int, interpret: bool = False):
    """Full flagship forward renderer: fused Pallas round 0 + XLA texture
    gather / env + Pallas bounce rounds (ray-input kernel at compacted
    width) + the 5-tap AA loop.

    Returns fn(packed) -> [H, W, 3] radiance.  Differentiable end-to-end:
    the kernels carry a custom VJP whose backward re-shades in XLA with the
    kernel's own discrete decisions pinned (ops/pallas_grad.py), and every
    XLA-side stage (combine, compaction, AA scan) already has a VJP."""
    from ..render import pipeline as P
    from .pallas_grad import build_trace_round0

    n = width * height
    mc_mode = static.dof or static.stereo
    chunked = bool(static.chunk_pixels and static.chunk_pixels < n)

    def combine(packed, o, dirs_or_none):
        return combine_outputs(packed, static, o, dirs_or_none)

    def _tap_dirs(packed, aa_offset):
        """Miss-ray directions recomputed XLA-side for the env term."""
        from .camera import screen_rays

        frame = begin_frame(packed.camera, width / height)
        dt = packed.node_matrix.dtype
        off = jnp.asarray(aa_offset, dtype=dt).reshape(2)
        lin = jnp.arange(n)
        xs = (lin % width).astype(dt) + off[0]
        ys = (lin // width).astype(dt) + off[1]
        _, dirs = screen_rays(packed.camera, frame, float(width), float(height), xs, ys, 0.0)
        return dirs

    # AA-tap texel-gather reuse (round-4): taps 1..4 reuse the base tap's
    # gathered quads and re-gather only changed-key lanes (_reused_quads)
    texel_reuse_on = (
        static.texel_tap_reuse
        and static.aa_enabled
        and not static.aa_adaptive
        and not chunked
        and not mc_mode
        and TEX_BITMAP in static.tex_kinds_present
    )

    if not chunked and not mc_mode:
        kern = build_trace_round0(static, width, height, interpret)
        _finish_bounces = build_bounce_finisher(static, width, height, interpret, n)

        def render_tap(packed: ScenePacked, aa_offset):
            o = kern(packed, aa_offset)
            dirs = _tap_dirs(packed, aa_offset) if static.has_env else None
            color, cont, atten, ro, rd = combine(packed, o, dirs)
            return _finish_bounces(packed, color, cont, atten, ro, rd)

        if texel_reuse_on:

            def render_tap_plan(packed: ScenePacked, aa_offset):
                o = kern(packed, aa_offset)
                dirs = _tap_dirs(packed, aa_offset) if static.has_env else None
                color, cont, atten, ro, rd, plan = combine_outputs(
                    packed, static, o, dirs, texel_plan=True
                )
                return _finish_bounces(packed, color, cont, atten, ro, rd), plan

            def render_tap_reuse(packed: ScenePacked, aa_offset, plan):
                o = kern(packed, aa_offset)
                dirs = _tap_dirs(packed, aa_offset) if static.has_env else None
                color, cont, atten, ro, rd = combine_outputs(
                    packed, static, o, dirs, texel_reuse=plan
                )
                return _finish_bounces(packed, color, cont, atten, ro, rd)

    if chunked and not mc_mode:
        # MEMORY-BOUNDED fused path: the reference's bucket decomposition
        # reborn (renderer.d:194-213), same knob the XLA pipeline honors —
        # peak device memory scales with the slab, not the frame.
        # Slabs ride lax.map (differentiable scan); rays come from XLA
        # screen_rays into the ray-input kernel; the bounce machinery is
        # the identical build_bounce_finisher at slab width.
        C = -(-static.chunk_pixels // BLOCK) * BLOCK
        S = -(-n // C)
        n_pad = S * C
        kern_slab = build_trace_round0(static, width, height, interpret, n_rays=C)
        finish_slab = build_bounce_finisher(
            static, width, height, interpret, C, is_slab=True
        )

        def render_tap(packed: ScenePacked, aa_offset):
            from .camera import screen_rays

            frame = begin_frame(packed.camera, width / height)
            dt = packed.node_matrix.dtype
            off = jnp.asarray(aa_offset, dtype=dt).reshape(2)
            # pad lanes clamp onto the last pixel (recomputed, discarded)
            lin = jnp.minimum(jnp.arange(n_pad), n - 1)

            def slab(lin_s):
                xs = (lin_s % width).astype(dt) + off[0]
                ys = (lin_s // width).astype(dt) + off[1]
                o3, d3 = screen_rays(
                    packed.camera, frame, float(width), float(height), xs, ys, 0.0
                )
                o = kern_slab(packed, o3, d3)
                color, cont, atten, ro, rd = combine(
                    packed, o, d3 if static.has_env else None
                )
                return finish_slab(packed, color, cont, atten, ro, rd)

            img = jax.lax.map(slab, lin.reshape(S, C))
            return img.reshape(n_pad, 3)[:n]
    if mc_mode:
        # DoF / stereo: XLA generates the (jittered, offset) rays with the
        # SAME jax.random stream as render/pipeline.render_samples, the
        # ray-input kernel traces them — MC modes get the fused path too.
        if chunked:
            # chunk_pixels bounds device memory here too: each MC pass lax.maps the
            # ray batch through a slab-width kernel + bounce finisher
            C = -(-static.chunk_pixels // BLOCK) * BLOCK
            S_mc = -(-n // C)
            pad_mc = S_mc * C - n
            kern_rays = build_trace_round0(static, width, height, interpret, n_rays=C)
            finish_mc = build_bounce_finisher(
                static, width, height, interpret, C, is_slab=True
            )

            def trace_rays(packed, orig, dir):
                def padded(a):
                    # pad lanes re-trace the last ray; outputs are sliced
                    # off below, so their cotangents are exactly zero
                    if pad_mc:
                        a = jnp.concatenate(
                            [a, jnp.broadcast_to(a[-1:], (pad_mc, 3))]
                        )
                    return a.reshape(S_mc, C, 3)

                def slab(args):
                    o3, d3 = args
                    o = kern_rays(packed, o3, d3)
                    color, cont, atten, ro, rd = combine(
                        packed, o, d3 if static.has_env else None
                    )
                    return finish_mc(packed, color, cont, atten, ro, rd)

                img = jax.lax.map(slab, (padded(orig), padded(dir)))
                return img.reshape(S_mc * C, 3)[:n]

        else:
            kern_rays = build_trace_round0(static, width, height, interpret, n_rays=n)
            finish_mc = build_bounce_finisher(static, width, height, interpret, n)

            def trace_rays(packed, orig, dir):
                o = kern_rays(packed, orig, dir)
                color, cont, atten, ro, rd = combine(packed, o, dir if static.has_env else None)
                return finish_mc(packed, color, cont, atten, ro, rd)

        # adaptiveAA DoF fast path: the 4 AA taps (each a full dof_samples
        # MC loop — 4/5 of the frame's work) lane-compact to flagged-pixel
        # width, like the deterministic aa_fast path below.  Stereo stays
        # full-width (combine_stereo mixes both eyes before the mask).
        aa_mc_fast = (
            static.aa_enabled
            and static.aa_adaptive
            and static.dof
            and not static.stereo
            and not chunked
        )
        if aa_mc_fast:
            cap_mc = static.aa_capacity or -(-n // 32)
            cap_mc = max(BLOCK, -(-cap_mc // BLOCK) * BLOCK)
            kern_aa_mc = build_trace_round0(static, width, height, interpret, n_rays=cap_mc)
            finish_aa_mc = build_bounce_finisher(
                static, width, height, interpret, cap_mc, is_slab=True
            )

        def render(packed: ScenePacked, key=None):
            from .camera import screen_rays

            if key is None:
                key = jax.random.PRNGKey(0)
            frame = begin_frame(packed.camera, width / height)
            dt = packed.node_matrix.dtype
            lin = jnp.arange(n)
            xf = (lin % width).astype(dt)
            yf = (lin // width).astype(dt)
            W, H = float(width), float(height)

            def trace_one(xx, yy, k):
                if static.stereo:
                    ol, dl = screen_rays(packed.camera, frame, W, H, xx, yy, -1.0, dof=static.dof, key=k)
                    orr, drr = screen_rays(packed.camera, frame, W, H, xx, yy, +1.0, dof=static.dof, key=k)
                    return P._combine_stereo(trace_rays(packed, ol, dl), trace_rays(packed, orr, drr))
                o3, d3 = screen_rays(packed.camera, frame, W, H, xx, yy, 0.0, dof=static.dof, key=k)
                return trace_rays(packed, o3, d3)

            def samples(xx, yy, k):
                # mirrors pipeline.render_samples' MC scan exactly
                if not static.dof:
                    return trace_one(xx, yy, k)
                n_samples = static.dof_samples

                def body(carry, _):
                    key, acc = carry
                    key, kj, kj2, kr = jax.random.split(key, 4)
                    jx = xx + jax.random.uniform(kj, xx.shape, dtype=xx.dtype)
                    jy = yy + jax.random.uniform(kj2, yy.shape, dtype=yy.dtype)
                    return (key, acc + trace_one(jx, jy, kr)), None

                (_, acc), _ = jax.lax.scan(
                    body, (k, jnp.zeros(xx.shape + (3,), dtype=xx.dtype)), None, length=n_samples
                )
                return acc / n_samples

            # mirrors pipeline._render_pixels: base sample + 4 AA taps
            key, k0 = jax.random.split(key)
            img = samples(xf, yf, k0)
            if static.aa_enabled and aa_mc_fast:
                mask = P.aa_detect(img.reshape(height, width, 3)).reshape(-1)
                count = mask.sum()
                offsets = jnp.asarray(P.AA_KERNEL, dtype=dt)

                def full_aa(img, key):
                    def aa_body(carry, off):
                        key, acc = carry
                        key, kk = jax.random.split(key)
                        return (key, acc + samples(xf + off[0], yf + off[1], kk)), None

                    (_, acc), _ = jax.lax.scan(aa_body, (key, img), offsets)
                    return jnp.where(mask[:, None], acc / 5.0, img)

                def compact_aa(img, key):
                    sel = P.compact_indices(mask, n, cap_mc)
                    selc = jnp.minimum(sel, n - 1)
                    live = jnp.arange(cap_mc) < count
                    xs0 = (selc % width).astype(dt)
                    ys0 = (selc // width).astype(dt)
                    base_g = img[selc]

                    def trace_c(o3, d3):
                        o = kern_aa_mc(packed, o3, d3)
                        color, cont, atten, ro, rd = combine(
                            packed, o, d3 if static.has_env else None
                        )
                        return finish_aa_mc(packed, color, cont, atten, ro, rd)

                    def samples_c(xx, yy, k):
                        # the dof MC loop with the FULL-WIDTH RNG stream:
                        # threefry uniforms are positional, so drawing
                        # (n,) and gathering [selc] reproduces exactly what
                        # full-width lanes selc would draw (the in-shape
                        # draw a [cap] batch would make is a DIFFERENT
                        # stream) — compacted output == full-width output
                        def body(carry, _):
                            key, acc = carry
                            key, kj, kj2, kr = jax.random.split(key, 4)
                            jx = xx + jax.random.uniform(kj, (n,), dtype=dt)[selc]
                            jy = yy + jax.random.uniform(kj2, (n,), dtype=dt)[selc]
                            k1, k2 = jax.random.split(kr)
                            u1 = jax.random.uniform(k1, (n,), dtype=dt)[selc]
                            u2 = jax.random.uniform(k2, (n,), dtype=dt)[selc]
                            o3, d3 = screen_rays(
                                packed.camera, frame, W, H, jx, jy, 0.0,
                                dof=True, disc_uv=(u1, u2),
                            )
                            return (key, acc + trace_c(o3, d3)), None

                        (_, acc), _ = jax.lax.scan(
                            body, (k, jnp.zeros((cap_mc, 3), dtype=dt)), None,
                            length=static.dof_samples,
                        )
                        return acc / static.dof_samples

                    def aa_body(carry, off):
                        key, acc = carry
                        key, kk = jax.random.split(key)
                        return (key, acc + samples_c(xs0 + off[0], ys0 + off[1], kk)), None

                    (_, acc), _ = jax.lax.scan(aa_body, (key, base_g), offsets)
                    blended = jnp.where(live[:, None], acc / 5.0, base_g)
                    tgt = jnp.where(live, sel, n)
                    return img.at[tgt].set(blended, mode="drop", indices_are_sorted=True)

                img = jax.lax.cond(count <= cap_mc, compact_aa, full_aa, img, key)
            elif static.aa_enabled:
                offsets = jnp.asarray(P.AA_KERNEL, dtype=dt)

                def aa_body(carry, off):
                    key, acc = carry
                    key, kk = jax.random.split(key)
                    s = samples(xf + off[0], yf + off[1], kk)
                    return (key, acc + s), None

                (_, acc), _ = jax.lax.scan(aa_body, (key, img), offsets)
                if static.aa_adaptive:
                    # adaptiveAA (stereo / chunked MC): same key stream,
                    # the mask only selects — no compaction win
                    mask = P.aa_detect(img.reshape(height, width, 3)).reshape(-1)
                    img = jnp.where(mask[:, None], acc / 5.0, img)
                else:
                    img = acc / 5.0
            return img.reshape(height, width, 3)

        render.tap = None  # MC modes have no single deterministic tap
        return render

    aa_fast = static.aa_enabled and static.aa_adaptive and not chunked
    if aa_fast:
        # adaptiveAA extension, LANE-compacted.  Unlike the bounce rounds
        # (where lane compaction lost to block granularity because live
        # atten/orig/dir rows had to be gathered and scattered), the AA tap
        # set needs NO data movement to compact: the tap ray is pure
        # arithmetic in the flagged pixel's flat index (xs = sel % W,
        # ys = sel // W -> screen_rays), so the entire bookkeeping is ONE
        # n-key sort (compact_indices), one [cap, 3] base-row gather and
        # one [cap, 3] scatter-set — and the 4 extra taps + combine run at
        # flagged-pixel width (0.93 % of the flagship frame) instead of
        # flagged-BLOCK width (21.7 %).  Overflow lax.cond-falls-back to
        # full-width taps + mask select.
        # default n/32 (3.1 %) carries ~3x headroom over a 1 % flagged
        # fraction (edge pixels scale with LINEAR frame size, so smaller
        # frames flag a larger fraction) — tighten via aa_capacity when
        # the scene allows
        cap_aa = static.aa_capacity or -(-n // 32)
        cap_aa = max(BLOCK, -(-cap_aa // BLOCK) * BLOCK)
        kern_aa = build_trace_round0(static, width, height, interpret, n_rays=cap_aa)
        finish_aa = build_bounce_finisher(
            static, width, height, interpret, cap_aa, is_slab=True
        )
        offsets4 = jnp.asarray(P.AA_KERNEL, dtype=jnp.float32)

        def render(packed: ScenePacked, key=None):
            from .camera import screen_rays

            base = render_tap(packed, jnp.zeros(2, jnp.float32))  # [n, 3]
            mask = P.aa_detect(base.reshape(height, width, 3)).reshape(-1)
            count = mask.sum()

            def full_path(base):
                def body(acc, off):
                    return acc + render_tap(packed, off), None

                acc, _ = jax.lax.scan(body, base, offsets4)
                return jnp.where(mask[:, None], acc / 5.0, base)

            def compact_path(base):
                frame = begin_frame(packed.camera, width / height)
                dt = packed.node_matrix.dtype
                sel = P.compact_indices(mask, n, cap_aa)  # one n-key sort
                selc = jnp.minimum(sel, n - 1)  # sentinel clamp
                live = jnp.arange(cap_aa) < count
                xs0 = (selc % width).astype(dt)
                ys0 = (selc // width).astype(dt)
                base_g = base[selc]  # [cap, 3] row gather

                def tap(acc, off):
                    o3, d3 = screen_rays(
                        packed.camera, frame, float(width), float(height),
                        xs0 + off[0], ys0 + off[1], 0.0,
                    )
                    o = kern_aa(packed, o3, d3)
                    color, cont, atten, ro, rd = combine(
                        packed, o, d3 if static.has_env else None
                    )
                    return acc + finish_aa(packed, color, cont, atten, ro, rd), None

                acc, _ = jax.lax.scan(tap, base_g, offsets4)
                # every compacted lane IS flagged; junk lanes keep base
                blended = jnp.where(live[:, None], acc / 5.0, base_g)
                tgt = jnp.where(live, sel, n)  # junk -> dropped sentinel
                return base.at[tgt].set(blended, mode="drop", indices_are_sorted=True)

            img = jax.lax.cond(count <= cap_aa, compact_path, full_path, base)
            return img.reshape(height, width, 3)

        render.tap = render_tap
        return render

    def render(packed: ScenePacked, key=None):
        if not static.aa_enabled:
            return render_tap(packed, jnp.zeros(2, jnp.float32)).reshape(height, width, 3)
        offsets4 = jnp.asarray(P.AA_KERNEL, dtype=jnp.float32)
        if static.aa_adaptive:
            # adaptiveAA on a chunked / non-block-divisible frame: taps run
            # full-width (memory-bounded via render_tap's own slabs), the
            # mask only selects — correct semantics, no compaction win
            base = render_tap(packed, jnp.zeros(2, jnp.float32))
            mask = P.aa_detect(base.reshape(height, width, 3)).reshape(-1)

            def body(acc, off):
                return acc + render_tap(packed, off), None

            acc, _ = jax.lax.scan(body, base, offsets4)
            img = jnp.where(mask[:, None], acc / 5.0, base)
            return img.reshape(height, width, 3)
        if texel_reuse_on:
            # base tap gathers its quads once; taps 1..4 reuse them and
            # re-gather only changed-key lanes
            base, plan = render_tap_plan(packed, jnp.zeros(2, jnp.float32))

            def body(acc, off):
                return acc + render_tap_reuse(packed, off, plan), None

            acc, _ = jax.lax.scan(body, base, offsets4)
            return (acc / 5.0).reshape(height, width, 3)

        # all 5 AA taps through ONE traced tap (the offset is a runtime
        # kernel parameter): 1/5th the trace/compile of unrolled taps
        offsets = jnp.concatenate([jnp.zeros((1, 2), jnp.float32), offsets4])

        def body(acc, off):
            return acc + render_tap(packed, off), None

        img, _ = jax.lax.scan(body, jnp.zeros((n, 3), jnp.float32), offsets)
        return (img / 5.0).reshape(height, width, 3)

    render.tap = render_tap  # single-sample entry for tests / shims
    return render


def _lin_dirs(packed, width, height, lin_base, n, aa_offset):
    """Miss-ray directions (env term) for the contiguous pixel slice
    [lin_base, lin_base + n), recomputed XLA-side — the lin twin of
    build_flagship_renderer._tap_dirs."""
    from .camera import screen_rays

    frame = begin_frame(packed.camera, width / height)
    dt = packed.node_matrix.dtype
    off = jnp.asarray(aa_offset, dtype=dt).reshape(2)
    base = jax.lax.stop_gradient(jnp.asarray(lin_base)).astype(jnp.int32)
    lin = base + jnp.arange(n)
    xs = (lin % width).astype(dt) + off[0]
    ys = (lin // width).astype(dt) + off[1]
    _, dirs = screen_rays(packed.camera, frame, float(width), float(height), xs, ys, 0.0)
    return dirs


def build_rows_renderer(static: SceneStatic, width: int, height: int,
                        interpret: bool, n_lanes: int):
    """Fused flagship renderer for ONE contiguous slice of the flat pixel
    grid — the per-shard body of the distributed renderer (parallel/mesh.py;
    round-3 VERDICT item 1: the fused path must be the one that scales out,
    matching the reference where the bucket parallelism drives THE renderer,
    renderer.d:133-136).

    Returns ``rows(packed, lin_base, mask=None, base=None) -> [n_lanes, 3]``
    rendering pixels [lin_base, lin_base + n_lanes).  Ray-gen happens
    in-kernel from the lin slot, so per-lane math is bit-identical to the
    single-chip flagship kernel's lanes at the same linear pixel index.
    ``rows.tap(packed, lin_base, aa_offset)`` is the single-tap entry (the
    sharded adaptiveAA base pass).

    * quirk AA (aa_adaptive=False): every pixel averages the 5 kernel taps;
    * adaptiveAA: the caller computes the needs-AA mask on the GLOBAL frame
      (cross-shard neighbour reads) and passes this slice's ``mask``; taps
      lane-compact within the shard exactly like the single-chip aa_fast
      path (``base=None`` re-renders the base tap IN-trace so unflagged
      pixels keep their gradient path — grad callers rely on this);
    * chunk_pixels is honored per slice (lax.map slabs through the
      lin-input kernel — the 8K-under-the-mesh memory bound, VERDICT r3
      item 2; adaptive taps then run full-width like the single-chip
      chunked path).

    Deterministic Whitted scenes only (supports(static), no DoF/stereo/GI
    — the mesh layer keeps the XLA pipeline for MC modes)."""
    from ..render import pipeline as P
    from .pallas_grad import build_trace_round0

    assert supports(static) and not (static.dof or static.stereo)
    n = n_lanes
    is_slab = n < width * height
    chunked = bool(static.chunk_pixels and static.chunk_pixels < n)

    def combine(packed, o, dirs_or_none):
        return combine_outputs(packed, static, o, dirs_or_none)

    rows_reuse_on = (
        static.texel_tap_reuse
        and static.aa_enabled
        and not static.aa_adaptive
        and not chunked
        and TEX_BITMAP in static.tex_kinds_present
    )

    if not chunked:
        kern = build_trace_round0(static, width, height, interpret, n_rays=n, lin_input=True)
        finish = build_bounce_finisher(static, width, height, interpret, n, is_slab=is_slab)

        def render_tap(packed, lin_base, aa_offset):
            o = kern(packed, lin_base, aa_offset)
            dirs = (
                _lin_dirs(packed, width, height, lin_base, n, aa_offset)
                if static.has_env
                else None
            )
            color, cont, atten, ro, rd = combine(packed, o, dirs)
            return finish(packed, color, cont, atten, ro, rd)

        if rows_reuse_on:
            # AA-tap texel-gather reuse, per shard (see _reused_quads)

            def render_tap_plan(packed, lin_base, aa_offset):
                o = kern(packed, lin_base, aa_offset)
                dirs = (
                    _lin_dirs(packed, width, height, lin_base, n, aa_offset)
                    if static.has_env
                    else None
                )
                color, cont, atten, ro, rd, plan = combine_outputs(
                    packed, static, o, dirs, texel_plan=True
                )
                return finish(packed, color, cont, atten, ro, rd), plan

            def render_tap_reuse(packed, lin_base, aa_offset, plan):
                o = kern(packed, lin_base, aa_offset)
                dirs = (
                    _lin_dirs(packed, width, height, lin_base, n, aa_offset)
                    if static.has_env
                    else None
                )
                color, cont, atten, ro, rd = combine_outputs(
                    packed, static, o, dirs, texel_reuse=plan
                )
                return finish(packed, color, cont, atten, ro, rd)

    else:
        C = -(-static.chunk_pixels // BLOCK) * BLOCK
        S = -(-n // C)
        n_pad = S * C
        kern_slab = build_trace_round0(static, width, height, interpret, n_rays=C, lin_input=True)
        finish_slab = build_bounce_finisher(static, width, height, interpret, C, is_slab=True)

        def render_tap(packed, lin_base, aa_offset):
            base_i = jnp.asarray(lin_base).astype(jnp.int32)
            # slab bases stay exact in f32: multiples of BLOCK
            bases = (base_i + C * jnp.arange(S)).astype(jnp.float32)

            def slab(b):
                o = kern_slab(packed, b, aa_offset)
                dirs = (
                    _lin_dirs(packed, width, height, b, C, aa_offset)
                    if static.has_env
                    else None
                )
                color, cont, atten, ro, rd = combine(packed, o, dirs)
                return finish_slab(packed, color, cont, atten, ro, rd)

            img = jax.lax.map(slab, bases)
            return img.reshape(n_pad, 3)[:n]

    offsets4 = jnp.asarray(P.AA_KERNEL, dtype=jnp.float32)
    zero2 = jnp.zeros(2, jnp.float32)

    aa_compact = static.aa_enabled and static.aa_adaptive and not chunked
    if aa_compact:
        # per-slice share of the frame-level aa_capacity knob (default
        # n/32, same flagged-fraction headroom as the single-chip path)
        if static.aa_capacity:
            cap_aa = -(-static.aa_capacity * n // (width * height))
        else:
            cap_aa = -(-n // 32)
        cap_aa = max(BLOCK, -(-cap_aa // BLOCK) * BLOCK)
        kern_aa = build_trace_round0(static, width, height, interpret, n_rays=cap_aa)
        finish_aa = build_bounce_finisher(static, width, height, interpret, cap_aa, is_slab=True)

    def rows(packed: ScenePacked, lin_base, mask=None, base=None):
        lb = jnp.asarray(lin_base, jnp.float32).reshape(())
        if not static.aa_enabled:
            return render_tap(packed, lb, zero2)
        if not static.aa_adaptive:
            if rows_reuse_on:
                base, plan = render_tap_plan(packed, lb, zero2)

                def body(acc, off):
                    return acc + render_tap_reuse(packed, lb, off, plan), None

                acc, _ = jax.lax.scan(body, base, offsets4)
                return acc / 5.0
            # reference quirk semantics: every pixel = avg of the 5 taps
            offsets = jnp.concatenate([jnp.zeros((1, 2), jnp.float32), offsets4])

            def body(acc, off):
                return acc + render_tap(packed, lb, off), None

            img, _ = jax.lax.scan(body, jnp.zeros((n, 3), jnp.float32), offsets)
            return img / 5.0

        assert mask is not None, "adaptiveAA rows need the global-frame mask slice"
        if base is None:
            base = render_tap(packed, lb, zero2)

        def full_taps(base):
            def body(acc, off):
                return acc + render_tap(packed, lb, off), None

            acc, _ = jax.lax.scan(body, base, offsets4)
            return jnp.where(mask[:, None], acc / 5.0, base)

        if not aa_compact:
            return full_taps(base)

        count = mask.sum()

        def compact_taps(base):
            from .camera import screen_rays

            frame = begin_frame(packed.camera, width / height)
            dt = packed.node_matrix.dtype
            sel = P.compact_indices(mask, n, cap_aa)  # shard-local sort
            selc = jnp.minimum(sel, n - 1)
            live = jnp.arange(cap_aa) < count
            # GLOBAL pixel index of each flagged lane -> same screen_rays
            # floats as the single-chip aa_fast path (bit-identity)
            glin = lb.astype(jnp.int32) + selc
            xs0 = (glin % width).astype(dt)
            ys0 = (glin // width).astype(dt)
            base_g = base[selc]

            def tap(acc, off):
                o3, d3 = screen_rays(
                    packed.camera, frame, float(width), float(height),
                    xs0 + off[0], ys0 + off[1], 0.0,
                )
                o = kern_aa(packed, o3, d3)
                color, cont, atten, ro, rd = combine(
                    packed, o, d3 if static.has_env else None
                )
                return acc + finish_aa(packed, color, cont, atten, ro, rd), None

            acc, _ = jax.lax.scan(tap, base_g, offsets4)
            blended = jnp.where(live[:, None], acc / 5.0, base_g)
            tgt = jnp.where(live, sel, n)
            return base.at[tgt].set(blended, mode="drop", indices_are_sorted=True)

        return jax.lax.cond(count <= cap_aa, compact_taps, full_taps, base)

    rows.tap = render_tap
    return rows


def supports_gi(static: SceneStatic) -> bool:
    """GI through the want_hit kernel: all-Lambert scenes with
    kernel-supported geometry, no DoF (DoF dispatches first).  Scenes with
    Phong nodes take the XLA trace_path, which paints the reference's
    bogus-BRDF red marker on paths that hit one (shader.d:252-261 asserts;
    renderer.d:457 marker)."""
    if not static.gi_enabled or static.dof:
        return False
    if not static.nodes:
        return False
    if static.compensated_raygen:
        return False  # df32 ray-gen is an XLA-path opt-in (ops/camera.py)
    return all(ns.shader_kind == LAMBERT for ns in static.nodes)


def build_gi_tracer(static: SceneStatic, width: int, height: int,
                    interpret: bool, n_lanes: int, K: int = 1):
    """Kernel-backed trace_path twin for K path-slabs of ``n_lanes`` rays:
    ``trace(packed, orig[K*n_lanes, 3], dir, keys[K, 2]) -> [K*n_lanes, 3]``
    — closest-hit + NEE light sums in the fused want_hit kernel, BRDF
    sampling in XLA with trace_path's exact jax.random stream per slab.
    Factored out of build_gi_renderer so the mesh layer can plug it into
    render_samples per shard (parallel/mesh.py)."""
    assert supports_gi(static)
    from . import shade as S
    from .pallas_grad import build_trace_round0

    C = n_lanes
    kernR = build_trace_round0(static, width, height, interpret, n_rays=K * C, want_hit=True)
    has_bitmap = TEX_BITMAP in static.tex_kinds_present

    def hit_of(packed, o):
        """Kernel outputs -> (win, raw normal, diffuse albedo, light sum)."""
        win = o["win"]
        winc = jnp.maximum(win, 0)
        normal = jnp.stack([o["nx"], o["ny"], o["nz"]], axis=-1)
        diffuse = jnp.stack([o["dr"], o["dg"], o["db"]], axis=-1)
        if has_bitmap:
            onehot = S.node_onehot(static, winc)
            tex = S.bitmap_color(packed, static, winc, o["u"], o["v"], onehot)
            is_bmp = S.tex_kind_of(static, winc) == TEX_BITMAP
            diffuse = jnp.where(is_bmp[..., None], tex, diffuse)
        L = jnp.stack([o["lr"], o["lg"], o["lb"]], axis=-1)
        return win, normal, diffuse, L

    def trace_path_pallas(packed, orig, dir, keys):
        """Mirrors pipeline.trace_path's bounce loop, kernel-backed.

        ``orig``/``dir`` hold K path-slabs of C rays ([K*C, 3]); ``keys``
        [K, 2] carries each slab's RNG chain.  Per-bounce uniforms are
        drawn per slab from its own chain (vmapped split), so every lane
        sees the exact value the sequential per-path scan would draw."""
        eps = S.shadow_eps(orig.dtype)
        acc = jnp.zeros_like(orig)
        mult = jnp.ones_like(orig)
        alive = jnp.ones(orig.shape[:-1], dtype=bool)

        def draw_uniform(ks):
            # [K, 2] keys -> [K*C] uniforms, path-slab j from key j
            return jax.vmap(lambda k: jax.random.uniform(k, (C,), dtype=orig.dtype))(
                ks
            ).reshape(K * C)

        # kernel L includes ambient (shade_direct's base); the NEE term
        # (trace_path) wants only the per-light visibility-weighted sum
        def bounce(carry):
            keys, acc, mult, alive, orig, dir = carry
            o = kernR(packed, orig, dir)
            win, normal, diffuse, L = hit_of(packed, o)
            hitmask = alive & (win >= 0)
            N = S.faceforward(dir, normal)
            mult_eff = jnp.ones_like(mult) if static.gi_multiplier_quirk else mult

            if static.has_env:
                from .env import sample_cubemap

                env = sample_cubemap(packed.env_cubemap, dir)
                acc = acc + jnp.where((alive & (win < 0))[..., None], mult_eff * env, 0.0)

            if static.gi_point_light_direct:
                # kernel L = ambient + sum_l vis*cos/d^2*lc, with the SAME
                # faceforward N and shadow origin as shade_direct; the NEE
                # term is diffuse/pi * (L - ambient)
                nee = diffuse * (1.0 / jnp.pi) * (L - packed.ambient)
                acc = acc + jnp.where(hitmask[..., None], mult_eff * nee, 0.0)
            # else: reference direct term == 0 exactly (solidAngle = 0)

            # Lambert.spawnRay (shader.d:118-135) — identical RNG stream to
            # pipeline.trace_path, per path slab
            sp = jax.vmap(lambda k: jax.random.split(k, 3))(keys)  # [K, 3, 2]
            keys = sp[:, 0]
            u = draw_uniform(sp[:, 1])
            v = draw_uniform(sp[:, 2])
            theta = 2 * jnp.pi * u
            phi = jnp.arccos(jnp.clip(2 * v - 1, -1.0, 1.0)) - jnp.pi / 2
            w = jnp.stack(
                [jnp.cos(theta) * jnp.cos(phi), jnp.sin(phi), jnp.sin(theta) * jnp.cos(phi)], axis=-1
            )
            w = jnp.where((w * N).sum(-1)[..., None] < 0, -w, w)
            color_eval = diffuse * (1 / jnp.pi) * jnp.maximum(0.0, (w * N).sum(-1))[..., None]
            pdf = 1 / (2 * jnp.pi)
            mult = mult * color_eval / pdf
            ts = jnp.where(hitmask, o["t"], 0.0)
            p = orig + dir * ts[..., None]
            orig = jnp.where(hitmask[..., None], p + N * eps, orig)
            dir = jnp.where(hitmask[..., None], w, dir)
            return (keys, acc, mult, hitmask, orig, dir)

        carry = (keys, acc, mult, alive, orig, dir)
        carry = bounce(carry)
        for _ in range(static.max_trace_depth):
            # skip all-dead rounds at runtime (forward-only path)
            carry = jax.lax.cond(carry[3].any(), bounce, lambda c: c, carry)
        return carry[1]

    return trace_path_pallas


def build_gi_renderer(static: SceneStatic, width: int, height: int, interpret: bool = False):
    """GI path tracer with the closest-hit + NEE-light-sum work done by the
    fused want_hit kernel; BRDF (hemisphere) sampling, throughput and the
    environment miss term stay in XLA — mirroring render/pipeline.trace_path
    op for op (same jax.random stream, so outputs match the XLA path to
    kernel-vs-XLA fp).

    With static.chunk_pixels set below the frame size, the pixel batch
    runs in lax.map slabs through a slab-width kernel, mirroring
    render_frame's chunked XLA structure (incl. its per-slab key splits) —
    memory-bounded GI frames keep the fused path instead of falling back
    to the ~2x slower XLA pipeline (round-3 VERDICT item 5).

    Returns fn(packed, key) -> [H, W, 3]."""
    assert supports_gi(static)
    from ..render import pipeline as P
    from . import shade as S

    n = width * height
    chunked = bool(static.chunk_pixels and static.chunk_pixels < n)
    if chunked:
        # slab width = chunk_pixels EXACTLY (not kernel-tile rounded like
        # the deterministic paths): MC RNG draws are slab-shaped, so the
        # slab boundaries must match the chunked XLA pipeline's for the
        # streams to agree.  The kernel pads its own lanes to BLOCK.
        C = static.chunk_pixels
        S_slabs = -(-n // C)
    else:
        C, S_slabs = n, 1
    # PATH BATCHING (default K=1): evaluating K paths per launch (lanes =
    # K*n) with exactly-unrolled per-path RNG chains cuts launch count
    # K-fold, but a batch runs bounce round r if ANY of its K paths still
    # has alive lanes, so per-path dead-round cond-skips are lost.  The
    # machinery stays behind static.gi_path_batch.
    if static.gi_path_batch:
        K = static.gi_path_batch
        assert static.paths_per_pixel % K == 0, (static.paths_per_pixel, K)
    else:
        K = 1
    # every round traces caller rays (round 0's are the jittered MC camera
    # rays generated in XLA), so only the ray-input kernel is needed; the
    # diff wrapper makes GI fitting work through the fused path too
    # (kernel + NEE + BRDF-sampling loop factored into build_gi_tracer)
    trace_path_pallas = build_gi_tracer(static, width, height, interpret, C, K)

    def render(packed: ScenePacked, key=None):
        """Mirrors pipeline.render_samples' MC scan + _render_pixels AA."""
        from .camera import screen_rays

        if key is None:
            key = jax.random.PRNGKey(0)
        frame = begin_frame(packed.camera, width / height)
        dt = packed.node_matrix.dtype
        lin = jnp.arange(n)
        xf = (lin % width).astype(dt)
        yf = (lin // width).astype(dt)
        W, H = float(width), float(height)

        def samples(xx, yy, k):
            def body(carry, _):
                key, acc = carry
                # unroll K iterations of the sequential key chain exactly:
                # batch j's (kj, kj2, kr) are what sequential path i*K+j
                # would have drawn
                kjs, kj2s, krs = [], [], []
                for _j in range(K):
                    key, kj, kj2, kr = jax.random.split(key, 4)
                    kjs.append(kj)
                    kj2s.append(kj2)
                    krs.append(kr)

                def jit_u(ks, base):
                    return (
                        base[None, :]
                        + jax.vmap(lambda kk: jax.random.uniform(kk, base.shape, dtype=base.dtype))(
                            jnp.stack(ks)
                        )
                    ).reshape(K * C)

                jx = jit_u(kjs, xx)
                jy = jit_u(kj2s, yy)
                o3, d3 = screen_rays(packed.camera, frame, W, H, jx, jy, 0.0)
                out = trace_path_pallas(packed, o3, d3, jnp.stack(krs))
                acc = acc + out.reshape(K, C, 3).sum(axis=0)
                return (key, acc), None

            # gi_remat_paths: recompute each path's forward in the backward
            # instead of stacking paths_per_pixel x bounce-round residuals
            # (models/packed.py)
            body_fn = jax.checkpoint(body) if static.gi_remat_paths else body
            (_, acc), _ = jax.lax.scan(
                body_fn, (k, jnp.zeros(xx.shape + (3,), dtype=xx.dtype)), None,
                length=static.paths_per_pixel // K,
            )
            return acc / static.paths_per_pixel

        if chunked:
            # mirror render_frame's chunked XLA structure (incl. every key
            # split) so the memory knob composes with the fused GI path
            pad = S_slabs * C - n

            def padded(a):
                return jnp.concatenate([a, jnp.zeros(pad, dtype=dt)]).reshape(S_slabs, C)

            if static.aa_enabled and static.aa_adaptive:
                # adaptive chunked: base pass + per-tap _flat_pass twins
                def flat_pass(xx, yy, k):
                    keys = jax.random.split(k, S_slabs)
                    out = jax.lax.map(
                        lambda a: samples(a[0], a[1], a[2]), (padded(xx), padded(yy), keys)
                    )
                    return out.reshape(-1, 3)[:n]

                key, k0 = jax.random.split(key)
                base = flat_pass(xf, yf, k0)
                mask = P.aa_detect(base.reshape(height, width, 3)).reshape(-1)
                offsets = jnp.asarray(P.AA_KERNEL, dtype=dt)

                def aa_body(carry, off):
                    key, acc = carry
                    key, kk = jax.random.split(key)
                    return (key, acc + flat_pass(xf + off[0], yf + off[1], kk)), None

                (_, acc), _ = jax.lax.scan(aa_body, (key, base), offsets)
                img = jnp.where(mask[:, None], acc / 5.0, base)
                return img.reshape(height, width, 3)

            # non-adaptive: per-slab base + AA taps (pipeline._render_pixels
            # per lax.map slab, same per-slab key discipline)
            keys = jax.random.split(key, S_slabs)

            def slab_body(args):
                cx, cy, ck = args
                ck, k0 = jax.random.split(ck)
                img = samples(cx, cy, k0)
                if static.aa_enabled:
                    offsets = jnp.asarray(P.AA_KERNEL, dtype=dt)

                    def aa_body(carry, off):
                        kk2, acc = carry
                        kk2, kk = jax.random.split(kk2)
                        return (kk2, acc + samples(cx + off[0], cy + off[1], kk)), None

                    (_, acc), _ = jax.lax.scan(aa_body, (ck, img), offsets)
                    img = acc / 5.0
                return img

            img = jax.lax.map(slab_body, (padded(xf), padded(yf), keys))
            return img.reshape(-1, 3)[:n].reshape(height, width, 3)

        key, k0 = jax.random.split(key)
        img = samples(xf, yf, k0)
        if static.aa_enabled:
            offsets = jnp.asarray(P.AA_KERNEL, dtype=dt)

            def aa_body(carry, off):
                key, acc = carry
                key, kk = jax.random.split(key)
                s = samples(xf + off[0], yf + off[1], kk)
                return (key, acc + s), None

            (_, acc), _ = jax.lax.scan(aa_body, (key, img), offsets)
            if static.aa_adaptive:
                # adaptiveAA: same key stream, the mask only selects
                mask = P.aa_detect(img.reshape(height, width, 3)).reshape(-1)
                img = jnp.where(mask[:, None], acc / 5.0, img)
            else:
                img = acc / 5.0
        return img.reshape(height, width, 3)

    return render


def build_primary_kernel(static: SceneStatic, width: int, height: int, interpret: bool = False):
    """Back-compat shim: single-tap flat [N, 3] radiance through the
    flagship round-0 path.  fn(packed, offset=(0, 0)) -> [N, 3].

    ``offset`` must be a CONCRETE pair (it is concretized via numpy) —
    traced offsets go through build_flagship_renderer's tap, whose AA
    offset is a runtime kernel parameter."""
    import dataclasses

    st = dataclasses.replace(static, aa_enabled=False)
    renderer = build_flagship_renderer(st, width, height, interpret)
    assert renderer.tap is not None, "MC sampling modes have no deterministic single tap"

    def fn(packed, offset=(0.0, 0.0)):
        off = tuple(np.asarray(offset).reshape(2).tolist())
        return renderer.tap(packed, off).reshape(-1, 3)

    return fn
