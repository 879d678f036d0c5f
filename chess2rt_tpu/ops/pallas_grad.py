"""Differentiable fused round-0: custom-VJP wrapper over the Pallas kernel.

Inverse rendering (the framework's north star, grad/inverse.fit) runs its
forward through the fused kernel (ops/pallas_trace.py), which has no VJP
of its own.  This module gives it one:

* **forward** = the fused Pallas kernel itself (ray-gen + closest-hit +
  shadow scans + direct shading in registers);
* **backward** = ``jax.vjp`` of an XLA *re-shade* that recomputes the
  kernel's continuous math with the discrete structure PINNED to the
  kernel's own decisions, saved as kernel outputs:
    - the winning node id ``win`` — the closest-hit running-min select
      collapses to piecewise-constant selects;
    - the winning hit's t and raw normal (``want_hit`` outputs) — matched
      once (forward-only, stop_gradient) against each leaf primitive's
      closed-form candidate solutions to pin WHICH leaf and which of its
      roots/faces won (compute_leaf_pins), so the differentiable
      recompute is one closed form per leaf (leaf_pinned_record): no CSG
      interval walk or all-hits sort network ever runs in the backward;
    - per-light shadow-visibility bits (``want_vis`` outputs) — the
      any-hit occlusion scans, the single most expensive part of the XLA
      forward, never run in the backward.  Their VJP is identically zero
      anyway (comparisons only), exactly the property the XLA pipeline's
      ``save_only_these_names("shadow_vis")`` remat policy exploits.

Gradients therefore flow through the same continuous formulas as the pure
XLA VJP — ops/geometry.node_closest partials (sphere/cube/plane/CSG winner
record, transform dist-rescaling, rt/node.d:51-67), the Lambert/Phong
direct terms (rt/shader.d:67-105), and the reflection/refraction
continuation algebra — while both the forward and the backward's primal
recompute skip every discrete scan.  Deferred pieces (bitmap texels,
environment misses, bounce compaction) already live in differentiable XLA
(ops/pallas_trace.combine_outputs, ops/shade.quad_gather_flat), so the whole
flagship renderer composes into ``jax.value_and_grad`` unchanged.

Discrete-pin caveat (standard differentiable rendering, SURVEY.md §7.0):
at lanes where kernel and XLA fp would disagree about a knife-edge winner
or shadow bit, the two VJPs differ; everywhere else they agree to fp
tolerance (tests/test_pallas_grad.py pins this against the XLA pipeline).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.packed import (
    LAMBERT,
    PHONG,
    REFLECTION,
    REFRACTION,
    TEX_BITMAP,
    TEX_CHECKER,
    TEX_PROC2,
    ScenePacked,
    SceneStatic,
    leaf_table,
)
from . import geometry as G
from . import shade as S
from .camera import begin_frame, screen_rays
from .pallas_trace import EPS_SHADOW, INF, build_round0_kernel


# shared guarded helpers (the 1e-30 floor is the NaN-free-dead-lane
# invariant — one definition, ops/geometry.py)
_norm = G._norm
dot = G.dot


# --------------------------------------------------------------------------
# XLA re-shade with pinned discrete structure
# --------------------------------------------------------------------------


def _node_space(packed, static, i, orig, dir):
    """Node-i canonic-space rays (the node.d:51-67 round trip): returns
    (orig_l, dir_l, inv_dl, m_inv); inv_dl/m_inv are None for
    identity/offset-only nodes (no dist rescale, no normal transform)."""
    ns = static.nodes[i]
    if ns.identity_transform:
        return orig, dir, None, None
    offset = packed.node_offset[i]
    if ns.offset_only:
        return orig - offset, dir, None, None
    m_inv = jnp.linalg.inv(packed.node_matrix[i])
    co = (orig - offset) @ m_inv
    cd = dir @ m_inv
    dlen = jnp.sqrt(jnp.maximum(dot(cd, cd), 1e-30))
    return co, cd / dlen[..., None], 1.0 / dlen, m_inv


def _leaf_candidates(packed, kind, k, o_l, d_l):
    """Closed-form candidate hit distances of one geometry leaf in LOCAL
    units, INF-masked exactly like the real intersectors; one
    (dist, sel) pair per solution branch (plane: 1; sphere: the two
    quadratic roots; cube: the six faces)."""
    if kind == "plane":
        rec = G.plane_closest(packed.plane_y[k], packed.plane_limit[k], o_l, d_l)
        return [(rec["dist"], 0)]
    if kind == "sphere":
        has, x1, x2 = G._sphere_roots(packed.sphere_center[k], packed.sphere_r[k], o_l, d_l)
        return [
            (jnp.where(has & (x2 >= 0), x2, INF), 0),
            (jnp.where(has & (x1 >= 0), x1, INF), 1),
        ]
    faces = G._cube_face_candidates(packed.cube_center[k], packed.cube_side[k], o_l, d_l)
    return [(faces["dist"][..., fi], fi) for fi in range(6)]


def compute_leaf_pins(packed, static, orig, dir, win, t_pin):
    """(gleaf, sel) int32 pins: which global leaf (models/packed.leaf_table
    numbering) and which of its solution branches produced the kernel's
    winning hit, found by nearest-|t| matching against the saved winning
    distance.  Every CSG boundary crossing IS one of its leaves' closed-form
    solutions, so the match recovers the parity walk's decision without
    re-running it.  Pure forward-only compare-selects — the caller wraps
    the inputs in stop_gradient and runs this ONCE per backward."""
    leaves, _ = leaf_table(static)
    best = jnp.full(win.shape, INF)
    gleaf = jnp.zeros(win.shape, jnp.int32)
    sel = jnp.zeros(win.shape, jnp.int32)
    space = {}
    for g, (i, kind, k) in enumerate(leaves):
        if i not in space:
            space[i] = _node_space(packed, static, i, orig, dir)
        o_l, d_l, inv_dl, _ = space[i]
        for t_loc, s in _leaf_candidates(packed, kind, k, o_l, d_l):
            t_w = t_loc if inv_dl is None else jnp.where(t_loc >= INF, INF, t_loc * inv_dl)
            err = jnp.where(win == i, jnp.abs(t_w - t_pin), INF)
            better = err < best
            best = jnp.where(better, err, best)
            gleaf = jnp.where(better, g, gleaf)
            sel = jnp.where(better, s, sel)
    return gleaf, sel


def _tangent_row(packed, static, i, local3):
    """World-space tangent frame of a CONSTANT local tangent of node ``i``:
    ``_norm(local3 @ m_fwd)`` computed on [3] vectors (node.d:45-46).
    For identity/offset-only nodes this is the local constant itself."""
    ns = static.nodes[i]
    v = jnp.asarray(local3, packed.node_offset.dtype)
    if ns.identity_transform or ns.offset_only:
        return v
    w = v @ packed.node_matrix[i]
    return w * jax.lax.rsqrt(jnp.maximum((w * w).sum(), 1e-30))


def leaf_pinned_record(packed, static, orig, dir, gleaf, sel, n_pin, tangents=False):
    """Differentiable winning-hit record reconstructed from the pinned
    (leaf, solution) ids: the closed form of ONE primitive per ray,
    where-selected across the static leaf list.  O(leaves) simple closed
    forms — no CSG interval walks, no all-hits sort networks, which
    _pinned_record (the O(nodes) full-scan fallback) pays in both the
    primal and the transpose.  Gradient-equivalent to the XLA VJP: the
    running-min/parity selects it skips are piecewise-constant.

    The CsgDiff eaten-surface normal flip (geometry.d:377-397) is
    recovered by sign-matching against the kernel's saved raw normal
    ``n_pin`` — piecewise-constant (computed on stop_gradient values).

    ``tangents`` adds the dNdx/dNdy frames for the bump extension — per
    pinned leaf these are closed forms too (plane/cube: face constants,
    geometry.d:47-53/:227-228; sphere: the azimuth frame, :110-122).  The
    CSG diff flip applies to the normal only, never the tangents, exactly
    like all_hits_expr."""
    leaves, _ = leaf_table(static)
    rec = None
    space = {}
    keys = ("dist", "normal", "u", "v") + (("dndx", "dndy") if tangents else ())
    for g, (i, kind, k) in enumerate(leaves):
        if i not in space:
            space[i] = _node_space(packed, static, i, orig, dir)
        o_l, d_l, inv_dl, m_inv = space[i]
        if kind == "plane":
            cand = G.plane_closest(packed.plane_y[k], packed.plane_limit[k], o_l, d_l)
            if tangents:
                # world-space constants per node (geometry.d:47-53): computed
                # as [3] vectors THEN broadcast
                cand["dndx"] = jnp.broadcast_to(
                    _tangent_row(packed, static, i, (1.0, 0.0, 0.0)), o_l.shape
                )
                cand["dndy"] = jnp.broadcast_to(
                    _tangent_row(packed, static, i, (0.0, 0.0, 1.0)), o_l.shape
                )
        elif kind == "sphere":
            c, r = packed.sphere_center[k], packed.sphere_r[k]
            has, x1, x2 = G._sphere_roots(c, r, o_l, d_l)
            t = jnp.where(sel == 1, x1, x2)
            ok = has & (t >= 0)
            cand = G._sphere_record(c, r, o_l, d_l, jnp.where(ok, t, 0.0), tangents)
            cand["dist"] = jnp.where(ok, t, INF)
        else:  # cube: static face select by the pinned face id
            faces = G._cube_face_candidates(packed.cube_center[k], packed.cube_side[k], o_l, d_l)
            cand = {
                "dist": faces["dist"][..., 0],
                "normal": faces["normal"][..., 0, :],
                "u": faces["u"][..., 0],
                "v": faces["v"][..., 0],
            }
            for fi in range(1, 6):
                m = sel == fi
                mv = m[..., None]
                cand = {
                    "dist": jnp.where(m, faces["dist"][..., fi], cand["dist"]),
                    "normal": jnp.where(mv, faces["normal"][..., fi, :], cand["normal"]),
                    "u": jnp.where(m, faces["u"][..., fi], cand["u"]),
                    "v": jnp.where(m, faces["v"][..., fi], cand["v"]),
                }
            if tangents:
                # tangent quirk (geometry.d:227-228): every face keeps the
                # projected-space literals dNdx = (1,0,0), dNdy = (0,0,s)
                # — s selected by the pinned face id, no per-face stacks;
                # world frames via _tangent_row (see the plane note), with
                # the per-lane ±1 sign multiplied AFTER the normalize
                # (s = ±1 commutes with _norm up to its sign)
                s = jnp.full(sel.shape, G._CUBE_FACES[0][1], o_l.dtype)
                for fi in range(1, 6):
                    s = jnp.where(sel == fi, G._CUBE_FACES[fi][1], s)
                cand["dndx"] = jnp.broadcast_to(
                    _tangent_row(packed, static, i, (1.0, 0.0, 0.0)), o_l.shape
                )
                cand["dndy"] = s[..., None] * _tangent_row(packed, static, i, (0.0, 0.0, 1.0))
        if inv_dl is not None:
            miss = cand["dist"] >= INF
            cand["dist"] = jnp.where(miss, INF, cand["dist"] * inv_dl)
            cand["normal"] = _norm(cand["normal"] @ m_inv.T)
            if tangents and kind == "sphere":
                # node.d:45-46: tangents transform by the FORWARD matrix.
                # Sphere frames are genuinely per-lane so the [N,3] @ [3,3]
                # is the same safe pattern as the normal transform above;
                # plane/cube frames are node constants handled per-kind.
                m_fwd = packed.node_matrix[i]
                cand["dndx"] = _norm(cand["dndx"] @ m_fwd)
                cand["dndy"] = _norm(cand["dndy"] @ m_fwd)
        m = gleaf == g
        mv = m[..., None]
        if rec is None:
            rec = {key: cand[key] for key in keys}
        else:
            rec = {
                key: jnp.where(m if cand[key].ndim == m.ndim else mv, cand[key], rec[key])
                for key in keys
            }
    flip = jnp.where(dot(n_pin, jax.lax.stop_gradient(rec["normal"])) < 0, -1.0, 1.0)
    rec["normal"] = rec["normal"] * flip[..., None]
    return rec


def _pinned_record(packed, static, orig, dir, win, tangents=False):
    """The winning node's hit record, selected by the PINNED win id instead
    of a running-min compare (mirrors ops/geometry.scene_closest's per-node
    math; the select itself is piecewise-constant, matching the zero
    gradient the XLA argmin select carries).  ``tangents`` carries the
    dNdx/dNdy frames the bump extension perturbs along."""
    rec = None
    for i, ns in enumerate(static.nodes):
        cand = G.node_closest(packed, ns, i, orig, dir, tangents=tangents)
        if rec is None:
            rec = cand
        else:
            m = win == i
            mv = m[..., None]
            rec = {
                "dist": jnp.where(m, cand["dist"], rec["dist"]),
                "normal": jnp.where(mv, cand["normal"], rec["normal"]),
                "u": jnp.where(m, cand["u"], rec["u"]),
                "v": jnp.where(m, cand["v"], rec["v"]),
                "p": rec["p"],  # unused: the kernel recomputes p from t
                **(
                    {
                        "dndx": jnp.where(mv, cand["dndx"], rec["dndx"]),
                        "dndy": jnp.where(mv, cand["dndy"], rec["dndy"]),
                    }
                    if tangents
                    else {}
                ),
            }
    return rec


def _diffuse_nobitmap(packed, static, winc, u, v, onehot):
    """texture_color minus the bitmap branch — the kernel defers bitmap
    texels to XLA (combine_outputs), emitting dr = 0 for bitmap nodes, so
    the re-shade must reproduce that decomposition (NOT the fused XLA
    pipeline's, which multiplies texels in-shade)."""
    tk = S.tex_kind_of(static, winc)
    out = S.node_gather(onehot, packed.mat_color)
    present = static.tex_kinds_present

    if TEX_CHECKER in present:
        size = S.node_gather(onehot, packed.checker_size)
        x = jnp.floor(u / size).astype(jnp.int32)
        y = jnp.floor(v / size).astype(jnp.int32)
        white = ((x + y) & 1).astype(bool)
        checker = jnp.where(
            white[..., None],
            S.node_gather(onehot, packed.checker_c2),
            S.node_gather(onehot, packed.checker_c1),
        )
        out = jnp.where((tk == TEX_CHECKER)[..., None], checker, out)

    if TEX_PROC2 in present:
        su = jnp.sin(u[..., None] * S.node_gather(onehot, packed.proc2_freq_u))
        sv = jnp.sin(v[..., None] * S.node_gather(onehot, packed.proc2_freq_v))
        proc = (S.node_gather(onehot, packed.proc2_color_u) * su[..., None]).sum(-2) + (
            S.node_gather(onehot, packed.proc2_color_v) * sv[..., None]
        ).sum(-2)
        out = jnp.where((tk == TEX_PROC2)[..., None], proc, out)

    if TEX_BITMAP in present:
        out = jnp.where((tk == TEX_BITMAP)[..., None], 0.0, out)
    return out


def reshade(
    packed: ScenePacked,
    static: SceneStatic,
    orig,
    dir,
    win,
    vis_list,
    want_hit=False,
    rec_pins=None,
    bump=False,
):
    """Differentiable XLA recompute of the round-0 kernel's float outputs
    given pinned (win, vis).  Input/output contract mirrors
    build_round0_kernel: returns the same keys minus ``win`` and the vis
    residuals.  ``vis_list`` holds one boolean [N] mask per light.

    ``rec_pins`` = (gleaf, sel, n_pin) switches the winning-record
    recompute from the O(nodes) full scan (_pinned_record) to the
    leaf-pinned closed form (leaf_pinned_record) — same gradients, no CSG
    re-walk.

    ``bump``: carry dNdx/dNdy tangent frames in the pinned record and
    perturb the raw normal by the winning node's bump map BEFORE
    faceforward/lighting (renderer.d:370-372 hook order, same as
    pipeline._whitted_round) — the fused bump hybrid's shading engine
    (build_bump_round0)."""
    if rec_pins is not None:
        rec = leaf_pinned_record(packed, static, orig, dir, *rec_pins, tangents=bump)
    else:
        rec = _pinned_record(packed, static, orig, dir, win, tangents=bump)
    return _shade_pinned(
        packed, static, orig, dir, win, vis_list, rec, want_hit=want_hit, bump=bump
    )


def _shade_pinned(
    packed, static, orig, dir, win, vis_list, rec,
    want_hit=False, bump=False, diffuse=None,
):
    """The shading half of ``reshade``: direct lighting + continuation +
    output assembly for a GIVEN winning-hit record.  ``diffuse`` overrides
    the _diffuse_nobitmap recompute (the bump fast-forward passes the
    kernel's saved dr/dg/db, which use the identical decomposition)."""
    has_bitmap = TEX_BITMAP in static.tex_kinds_present
    has_refl = REFLECTION in static.shader_kinds_present
    has_refr = REFRACTION in static.shader_kinds_present
    has_cont = has_refl or has_refr
    has_phong = PHONG in static.shader_kinds_present
    emit_L = has_bitmap or want_hit

    hitmask = win >= 0
    winc = jnp.maximum(win, 0)
    onehot = S.node_onehot(static, winc)
    if bump:
        # perturb the RAW normal (pre-faceforward), exactly where the XLA
        # wavefront applies the hook (render/pipeline.py _whitted_round)
        rec = dict(rec, normal=S.apply_bump(packed, static, winc, rec, onehot))

    # world hit point from the winning t.  Dead lanes AND knife-edge lanes
    # where the kernel reported a hit the XLA recompute just misses
    # (dist == INF under slightly different fp) are clamped to t = 0:
    # the forward masks them out either way, but an unclamped INF would
    # leak NaN cotangents through the untaken where-branches in the
    # backward (the jax "where-NaN" trap), poisoning every geometry leaf.
    t_ok = hitmask & (rec["dist"] < INF)
    ts = jnp.where(t_ok, rec["dist"], 0.0)
    hp = orig + dir * ts[..., None]

    # faceforward (imported_types.d:69-73), kernel-style sign select
    ndotd = dot(dir, rec["normal"])
    sgn = jnp.where(ndotd < 0, 1.0, -1.0)
    N = rec["normal"] * sgn[..., None]
    sfrom = hp + N * EPS_SHADOW

    if diffuse is None:
        diffuse = _diffuse_nobitmap(packed, static, winc, rec["u"], rec["v"], onehot)

    # ---- direct lighting, shadow scans replaced by pinned vis bits ------
    L = jnp.broadcast_to(packed.ambient, hp.shape)
    spec = jnp.zeros_like(hp) if has_phong else None
    for li in range(static.n_lights):
        lp = packed.light_pos[li]
        lc = packed.light_color[li] * packed.light_power[li]
        vis = vis_list[li]
        to_l = lp - hp
        dist2 = dot(to_l, to_l)
        ldir = to_l * jax.lax.rsqrt(jnp.maximum(dist2, 1e-30))[..., None]
        cos_t = dot(ldir, N)
        w = jnp.where(vis & (cos_t > 0), cos_t / dist2, 0.0)
        L = L + lc * w[..., None]
        if has_phong:
            # R = reflect(-lightDir, N); cosGamma = R . -d (shader.d:226-249)
            mdotn = dot(-ldir, N)
            R = -ldir - 2.0 * mdotn[..., None] * N
            R = R * jax.lax.rsqrt(jnp.maximum(dot(R, R), 1e-30))[..., None]
            cos_g = dot(R, -dir)
            exponent = S.node_gather(onehot, packed.mat_exponent)
            strength = S.node_gather(onehot, packed.mat_strength)
            sw = jnp.where(
                vis & (cos_g > 0),
                jnp.power(jnp.maximum(cos_g, 0.0), exponent) * strength / dist2,
                0.0,
            )
            spec = spec + lc * sw[..., None]

    color = diffuse * L
    if has_phong:
        is_phong = S.shader_kind_of(static, winc) == PHONG
        color = color + jnp.where(is_phong[..., None], spec, 0.0)

    is_direct_vals = [1 if ns.shader_kind in (LAMBERT, PHONG) else 0 for ns in static.nodes]
    is_direct = S.static_select(winc, is_direct_vals).astype(bool)
    shaded = hitmask & is_direct

    out = {
        "r": jnp.where(shaded, color[..., 0], 0.0),
        "g": jnp.where(shaded, color[..., 1], 0.0),
        "b": jnp.where(shaded, color[..., 2], 0.0),
    }
    if emit_L:
        out["lr"] = jnp.where(shaded, L[..., 0], 0.0)
        out["lg"] = jnp.where(shaded, L[..., 1], 0.0)
        out["lb"] = jnp.where(shaded, L[..., 2], 0.0)
        out["u"] = rec["u"]
        out["v"] = rec["v"]

    if has_cont:
        # mirror continuation + single-sided refraction with TIR fallback,
        # replicating the kernel's op sequence (pallas_trace.py:944-994)
        ddn = dot(dir, N)
        rd = dir - 2.0 * ddn[..., None] * N
        rd = rd * jax.lax.rsqrt(jnp.maximum(dot(rd, rd), 1e-30))[..., None]
        ro = sfrom
        if has_refr:
            rn = rec["normal"]
            ior = S.node_gather(onehot, packed.mat_ior)
            is_refr = S.shader_kind_of(static, winc) == REFRACTION
            cos_in = -dot(dir, rn)
            entering = cos_in > 0
            eta = jnp.where(entering, 1.0 / ior, ior)
            nf = rn * jnp.where(entering, 1.0, -1.0)[..., None]
            ci = jnp.abs(cos_in)
            kk = 1.0 - eta * eta * (1.0 - ci * ci)
            tir = kk < 0
            # _safe_sqrt: at the TIR boundary (kk = 0) the plain sqrt's
            # derivative is inf — same grazing-lane poisoning as the
            # sphere discriminant (see geometry._safe_sqrt)
            coef = eta * ci - G._safe_sqrt(jnp.maximum(kk, 0.0))
            f = eta[..., None] * dir + coef[..., None] * nf
            f = f * jax.lax.rsqrt(jnp.maximum(dot(f, f), 1e-30))[..., None]
            rfd = jnp.where(tir[..., None], rd, f)
            rfo = jnp.where(tir[..., None], hp + nf * EPS_SHADOW, hp - nf * EPS_SHADOW)
            rd = jnp.where(is_refr[..., None], rfd, rd)
            ro = jnp.where(is_refr[..., None], rfo, ro)
        out["rox"], out["roy"], out["roz"] = ro[..., 0], ro[..., 1], ro[..., 2]
        out["rdx"], out["rdy"], out["rdz"] = rd[..., 0], rd[..., 1], rd[..., 2]

    if want_hit:
        out["t"] = jnp.where(t_ok, rec["dist"], INF)
        out["nx"], out["ny"], out["nz"] = (
            rec["normal"][..., 0],
            rec["normal"][..., 1],
            rec["normal"][..., 2],
        )
        out["dr"], out["dg"], out["db"] = diffuse[..., 0], diffuse[..., 1], diffuse[..., 2]
    return out


def _gen_rays(packed, width, height, aa):
    """XLA twin of the kernel's in-kernel ray-gen (pos-free corner
    interpolation — identical op sequence to ops/camera.screen_rays)."""
    n = width * height
    frame = begin_frame(packed.camera, width / height)
    dt = packed.camera.pos.dtype
    lin = jnp.arange(n)
    xs = (lin % width).astype(dt) + aa[0]
    ys = (lin // width).astype(dt) + aa[1]
    return screen_rays(packed.camera, frame, float(width), float(height), xs, ys, 0.0)


def _gen_rays_lin(packed, width, height, aa, lin_base, n):
    """_gen_rays for the contiguous pixel slice [lin_base, lin_base + n) —
    the XLA twin of the kernel's lin_input ray-gen (mesh shards / chunk
    slabs).  ``lin_base`` is a traced f32 scalar (exact integer)."""
    frame = begin_frame(packed.camera, width / height)
    dt = packed.camera.pos.dtype
    base = jax.lax.stop_gradient(jnp.asarray(lin_base)).astype(jnp.int32)
    lin = base + jnp.arange(n)
    xs = (lin % width).astype(dt) + aa[0]
    ys = (lin // width).astype(dt) + aa[1]
    return screen_rays(packed.camera, frame, float(width), float(height), xs, ys, 0.0)


# --------------------------------------------------------------------------
# Custom-VJP builders (drop-in for build_round0_kernel's run functions)
# --------------------------------------------------------------------------


def build_diff_round0(
    static: SceneStatic,
    width: int,
    height: int,
    interpret: bool = False,
    n_rays: int = None,
    want_hit: bool = False,
    pin_mode: str = "leaf",
    lin_input: bool = False,
):
    """A differentiable drop-in for ``build_round0_kernel``:

    * screen-tap form: ``fn(packed, aa_offset) -> o`` with cotangents for
      every ScenePacked leaf (incl. camera, via the XLA ray-gen twin);
    * ray-input form (``n_rays`` set): ``fn(packed, orig, dir) -> o`` with
      cotangents also flowing to orig/dir — bounce rounds chain gradients
      through the whole Whitted recursion.

    The primal call runs the plain kernel (identical cost to the
    forward-only path); only under differentiation does the fwd pass pay
    for the extra ``want_vis``/``want_hit`` residual outputs.

    ``pin_mode``: "leaf" (default) saves the winning t/normal as extra
    kernel residuals and reconstructs the winning record from closed-form
    leaf solutions in the backward; "node" re-scans every node's full
    intersection (the round-2 behavior, kept for A/B tests).

    ``lin_input`` (requires ``n_rays``): in-kernel ray-gen for the
    contiguous pixel slice [lin_base, lin_base + n_rays) — the mesh-shard
    / chunk-slab form ``fn(packed, lin_base, aa_offset)``.  Camera
    cotangents flow through the _gen_rays_lin XLA twin, exactly like the
    screen-tap form."""
    ray_input = n_rays is not None and not lin_input
    leaf_pins = pin_mode == "leaf" and len(leaf_table(static)[0]) > 0
    kern_plain = build_round0_kernel(
        static, width, height, interpret, n_rays=n_rays, want_hit=want_hit,
        lin_input=lin_input,
    )
    kern_resid = build_round0_kernel(
        static,
        width,
        height,
        interpret,
        n_rays=n_rays,
        want_hit=want_hit or leaf_pins,
        want_vis=True,
        lin_input=lin_input,
    )

    # the primal output keys of kern_plain (build_round0_kernel's name
    # assembly) — the residual kernel's extra outputs must be stripped
    # before returning from f_fwd (custom_vjp: fwd primal == f primal)
    has_bitmap = TEX_BITMAP in static.tex_kinds_present
    has_cont = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    primal_names = ["r", "g", "b", "win"]
    if has_bitmap or want_hit:
        primal_names += ["lr", "lg", "lb", "u", "v"]
    if has_cont:
        primal_names += ["rox", "roy", "roz", "rdx", "rdy", "rdz"]
    if want_hit:
        primal_names += ["t", "nx", "ny", "nz", "dr", "dg", "db"]
    vis_names = [f"vis{li}" for li in range(static.n_lights)]

    def _split(o):
        vis = [o[k] > 0.5 for k in vis_names]
        basic = {k: o[k] for k in primal_names}
        if leaf_pins:
            t_pin = o["t"]
            n_pin = jnp.stack([o["nx"], o["ny"], o["nz"]], axis=-1)
        else:
            t_pin = n_pin = None
        return basic, vis, t_pin, n_pin

    def _pins(packed, orig, dir, win, t_pin, n_pin):
        """Stop-gradient leaf-pin identification (None in node mode)."""
        if not leaf_pins:
            return None
        sg = jax.lax.stop_gradient
        gleaf, sel = compute_leaf_pins(sg(packed), static, sg(orig), sg(dir), win, t_pin)
        return (gleaf, sel, n_pin)

    def _vjp_through(g, fn, *primals):
        # g carries float0 for the int win output; reshade emits only the
        # float keys, so pair them up by name
        _, vjp = jax.vjp(fn, *primals)
        gs = {k: v for k, v in g.items() if k != "win"}
        return vjp(gs)

    if ray_input:

        @jax.custom_vjp
        def f(packed, orig, dir):
            return kern_plain(packed, orig, dir)

        def f_fwd(packed, orig, dir):
            basic, vis, t_pin, n_pin = _split(kern_resid(packed, orig, dir))
            return basic, (packed, orig, dir, basic["win"], vis, t_pin, n_pin)

        def f_bwd(res, g):
            packed, orig, dir, win, vis, t_pin, n_pin = res
            rp = _pins(packed, orig, dir, win, t_pin, n_pin)

            def rf(p, o3, d3):
                return reshade(p, static, o3, d3, win, vis, want_hit=want_hit, rec_pins=rp)

            return _vjp_through(g, rf, packed, orig, dir)

        f.defvjp(f_fwd, f_bwd)

        def run(packed, orig, dir, aa_offset=(0.0, 0.0)):
            return f(packed, orig, dir)

        return run

    if lin_input:

        @jax.custom_vjp
        def f(packed, lin_base, aa):
            return kern_plain(packed, lin_base, aa)

        def f_fwd(packed, lin_base, aa):
            basic, vis, t_pin, n_pin = _split(kern_resid(packed, lin_base, aa))
            return basic, (packed, lin_base, aa, basic["win"], vis, t_pin, n_pin)

        def f_bwd(res, g):
            packed, lin_base, aa, win, vis, t_pin, n_pin = res
            sg = jax.lax.stop_gradient
            so, sd = _gen_rays_lin(sg(packed), width, height, sg(aa), lin_base, n_rays)
            rp = _pins(packed, so, sd, win, t_pin, n_pin)

            def rf(p, a):
                orig, dir = _gen_rays_lin(p, width, height, a, lin_base, n_rays)
                return reshade(p, static, orig, dir, win, vis, want_hit=want_hit, rec_pins=rp)

            gp, ga = _vjp_through(g, rf, packed, aa)
            return gp, jnp.zeros((), jnp.float32), ga

        f.defvjp(f_fwd, f_bwd)

        def run(packed, lin_base, aa_offset=(0.0, 0.0)):
            return f(
                packed,
                jnp.asarray(lin_base, jnp.float32).reshape(()),
                jnp.asarray(aa_offset, jnp.float32).reshape(2),
            )

        return run

    @jax.custom_vjp
    def f(packed, aa):
        return kern_plain(packed, aa)

    def f_fwd(packed, aa):
        basic, vis, t_pin, n_pin = _split(kern_resid(packed, aa))
        return basic, (packed, aa, basic["win"], vis, t_pin, n_pin)

    def f_bwd(res, g):
        packed, aa, win, vis, t_pin, n_pin = res
        sg = jax.lax.stop_gradient
        so, sd = _gen_rays(sg(packed), width, height, sg(aa))
        rp = _pins(packed, so, sd, win, t_pin, n_pin)

        def rf(p, a):
            orig, dir = _gen_rays(p, width, height, a)
            return reshade(p, static, orig, dir, win, vis, want_hit=want_hit, rec_pins=rp)

        return _vjp_through(g, rf, packed, aa)

    f.defvjp(f_fwd, f_bwd)

    def run(packed, aa_offset=(0.0, 0.0)):
        return f(packed, jnp.asarray(aa_offset, jnp.float32).reshape(2))

    return run


# --------------------------------------------------------------------------
# Bump hybrid round-0 (the BumpTexture extension on the fused path)
# --------------------------------------------------------------------------


def reconstruct_tangents(packed, static, winc, n_raw):
    """dNdx/dNdy of the winning hit reconstructed from the kernel's saved
    RAW world normal alone — per-node closed forms, NO re-intersection
    (the bump fast-forward, see build_bump_round0).

    Valid only for bump-mapped nodes whose geometry is a single primitive
    (_fast_bump_ok): pure-primitive normals never carry the CsgDiff
    eaten-surface flip, so the local normal (recovered through the
    forward matrix) determines the frame:

    * plane: the (1,0,0)/(0,0,1) world constants (geometry.d:47-53);
    * cube:  dNdx = (1,0,0) world const; dNdy = (0,0,s) with s the sign
             of the winning face — the local normal's single ±1 component
             (geometry.d:227-228 non-unproject quirk);
    * sphere: the azimuth frame from the local normal (∝ rel, so the
             atan2 is scale-invariant; geometry.d:110-122).

    Nodes without a bump map (or CSG nodes, gated out) contribute zeros —
    apply_bump's `has` mask keeps their normals unchanged.  NaN-free on
    every lane."""
    dndx = jnp.zeros_like(n_raw)
    dndy = jnp.zeros_like(n_raw)
    for i, ns in enumerate(static.nodes):
        if ns.bump_idx < 0 or ns.geom[0] == "csg":
            continue
        kind = ns.geom[0]
        full_tr = not (ns.identity_transform or ns.offset_only)
        if full_tr:
            m_fwd = packed.node_matrix[i]
            n_l = _norm(n_raw @ m_fwd.T)  # n_w = _norm(n_l @ m_inv.T) inverted
        else:
            n_l = n_raw
        if kind == "plane":
            cx = jnp.broadcast_to(
                _tangent_row(packed, static, i, (1.0, 0.0, 0.0)), n_raw.shape
            )
            cy = jnp.broadcast_to(
                _tangent_row(packed, static, i, (0.0, 0.0, 1.0)), n_raw.shape
            )
        elif kind == "cube":
            s = jnp.sign(n_l.sum(-1))  # the face's ±1 (other comps are 0)
            cx = jnp.broadcast_to(
                _tangent_row(packed, static, i, (1.0, 0.0, 0.0)), n_raw.shape
            )
            cy = s[..., None] * _tangent_row(packed, static, i, (0.0, 0.0, 1.0))
        else:  # sphere: same op sequence as _sphere_record's tangent block
            angle = jnp.arctan2(n_l[..., 2], n_l[..., 0])
            cx = jnp.stack(
                [jnp.cos(angle + jnp.pi / 2), jnp.zeros_like(angle),
                 jnp.sin(angle + jnp.pi / 2)],
                axis=-1,
            )
            cy = jnp.cross(cx, n_l)
            if full_tr:
                cx = _norm(cx @ m_fwd)
                cy = _norm(cy @ m_fwd)
        mask = (winc == i)[..., None]
        dndx = jnp.where(mask, cx, dndx)
        dndy = jnp.where(mask, cy, dndy)
    return dndx, dndy


def _fast_bump_ok(static: SceneStatic) -> bool:
    """True when every bump-mapped node is a single primitive — the
    reconstruct_tangents precondition (CSG winners may carry the diff
    flip, which makes the frame unrecoverable from the normal alone)."""
    return all(ns.geom[0] != "csg" for ns in static.nodes if ns.bump_idx >= 0)


def build_bump_round0(
    static: SceneStatic,
    width: int,
    height: int,
    interpret: bool = False,
    n_rays: int = None,
    lin_input: bool = False,
):
    """Hybrid round-0 for bump scenes, same call shapes / output keys as
    ``build_diff_round0``: the fused kernel pins the discrete structure
    (win + per-light vis + winning t/normal/u/v/diffuse — closest-hit AND
    the shadow any-hit scans stay in-kernel) and the XLA side applies the
    BumpTexture normal perturbation before lighting (renderer.d:370-372
    hook order).

    Two XLA engines, the build_diff_round0 split reapplied:

    * **fast forward** (primal, when _fast_bump_ok): the record comes
      STRAIGHT from the kernel's saved outputs, tangents reconstructed
      from the raw normal (reconstruct_tangents) — no leaf
      re-intersection; only bump + lighting + assembly run in XLA.
      Grad steps re-derive the reshade primal in the backward — the
      right trade: forward-only rendering is the hot case;
    * **differentiable reshade** (the custom-VJP backward, and the whole
      path for scenes with bump-mapped CSG nodes): tangent-carrying
      leaf-pinned records (leaf_pinned_record(tangents=True)), through
      which camera/geometry/material cotangents flow.

    Why a hybrid and not in-kernel bump: the perturbed normal feeds the
    in-kernel lighting sums, so the deferred-texel trick cannot compose
    while the bump atlas is sampled outside the kernel (the same split as
    bitmap texels).

    Divergence caveat vs the XLA wavefront (same class as the custom-VJP
    discrete-pin caveat above): the kernel's shadow-ray origin offsets
    along the UNBUMPED faceforward normal, the XLA path's along the
    geometric faceforward normal — identical since the geometric-offset
    convention (ops/shade.shade_direct) — and knife-edge winner lanes can
    still disagree at kernel-vs-XLA fp."""
    ray_input = n_rays is not None and not lin_input
    kern = build_round0_kernel(
        static, width, height, interpret, n_rays=n_rays,
        want_hit=True, want_vis=True, lin_input=lin_input,
    )
    vis_names = [f"vis{li}" for li in range(static.n_lights)]
    sg = jax.lax.stop_gradient
    fast = _fast_bump_ok(static)

    def _split(o):
        win = o["win"]
        vis = [o[k] > 0.5 for k in vis_names]
        t_pin = o["t"]
        n_pin = jnp.stack([o["nx"], o["ny"], o["nz"]], axis=-1)
        return win, vis, t_pin, n_pin

    def _pins_sg(packed, so, sd, win, t_pin, n_pin):
        """Leaf pins on stop-gradient values (one definition for every
        input form's backward — the forward/backward plumbing below must
        never drift between forms)."""
        gleaf, sel = compute_leaf_pins(
            sg(packed), static, sg(so), sg(sd), win, t_pin
        )
        return (gleaf, sel, n_pin)

    def _strip_win(g_or_out):
        return {k: v for k, v in g_or_out.items() if k != "win"}

    def _diff_out(packed, orig, dir, win, vis, t_pin, n_pin, rp=None):
        if rp is None:
            rp = _pins_sg(packed, orig, dir, win, t_pin, n_pin)
        out = reshade(
            packed, static, orig, dir, win, vis, rec_pins=rp, bump=True
        )
        out["win"] = win
        return out

    def _fast_out(packed, orig, dir, o):
        win, vis, t_pin, n_pin = _split(o)
        winc = jnp.maximum(win, 0)
        rec = {"dist": t_pin, "normal": n_pin, "u": o["u"], "v": o["v"]}
        rec["dndx"], rec["dndy"] = reconstruct_tangents(packed, static, winc, n_pin)
        diffuse = jnp.stack([o["dr"], o["dg"], o["db"]], axis=-1)
        out = _shade_pinned(
            packed, static, orig, dir, win, vis, rec, bump=True, diffuse=diffuse
        )
        out["win"] = win
        return out

    def _vjp_bump(g, packed, orig, dir, win, vis, t_pin, n_pin):
        """VJP of the differentiable reshade at the pinned structure
        (ray-input form; the screen/lin forms inline their ray-gen twin)."""
        rp = _pins_sg(packed, orig, dir, win, t_pin, n_pin)

        def rf(p, o3, d3):
            return _strip_win(_diff_out(p, o3, d3, win, vis, t_pin, n_pin, rp=rp))

        _, vjp = jax.vjp(rf, packed, orig, dir)
        return vjp(_strip_win(g))

    if not fast:
        # bump-mapped CSG nodes: the differentiable reshade IS the forward
        # (plain XLA, no custom VJP needed — the kernel runs on
        # stop_gradient inputs and contributes only discrete pins)
        if ray_input:

            def run(packed, orig, dir, aa_offset=(0.0, 0.0)):
                o = kern(sg(packed), sg(orig), sg(dir))
                return _diff_out(packed, orig, dir, *_split(o))

            return run

        if lin_input:

            def run(packed, lin_base, aa_offset=(0.0, 0.0)):
                lb = jnp.asarray(lin_base, jnp.float32).reshape(())
                aa = jnp.asarray(aa_offset, jnp.float32).reshape(2)
                o = kern(sg(packed), sg(lb), sg(aa))
                orig, dir = _gen_rays_lin(packed, width, height, aa, lb, n_rays)
                return _diff_out(packed, orig, dir, *_split(o))

            return run

        def run(packed, aa_offset=(0.0, 0.0)):
            aa = jnp.asarray(aa_offset, jnp.float32).reshape(2)
            o = kern(sg(packed), sg(aa))
            orig, dir = _gen_rays(packed, width, height, aa)
            return _diff_out(packed, orig, dir, *_split(o))

        return run

    # fast path: record from the kernel in the primal, reshade in the VJP
    if ray_input:

        @jax.custom_vjp
        def f(packed, orig, dir):
            o = kern(sg(packed), sg(orig), sg(dir))
            return _fast_out(packed, orig, dir, o)

        def f_fwd(packed, orig, dir):
            o = kern(sg(packed), sg(orig), sg(dir))
            return _fast_out(packed, orig, dir, o), (packed, orig, dir, _split(o))

        def f_bwd(res, g):
            packed, orig, dir, (win, vis, t_pin, n_pin) = res
            return _vjp_bump(g, packed, orig, dir, win, vis, t_pin, n_pin)

        f.defvjp(f_fwd, f_bwd)

        def run(packed, orig, dir, aa_offset=(0.0, 0.0)):
            return f(packed, orig, dir)

        return run

    if lin_input:

        @jax.custom_vjp
        def f(packed, lin_base, aa):
            o = kern(sg(packed), sg(lin_base), sg(aa))
            orig, dir = _gen_rays_lin(sg(packed), width, height, sg(aa), lin_base, n_rays)
            return _fast_out(packed, orig, dir, o)

        def f_fwd(packed, lin_base, aa):
            o = kern(sg(packed), sg(lin_base), sg(aa))
            so, sd = _gen_rays_lin(sg(packed), width, height, sg(aa), lin_base, n_rays)
            return _fast_out(packed, so, sd, o), (packed, lin_base, aa, _split(o))

        def f_bwd(res, g):
            packed, lin_base, aa, (win, vis, t_pin, n_pin) = res
            so, sd = _gen_rays_lin(sg(packed), width, height, sg(aa), lin_base, n_rays)
            rp = _pins_sg(packed, so, sd, win, t_pin, n_pin)

            def rf(p, a):
                orig, dir = _gen_rays_lin(p, width, height, a, lin_base, n_rays)
                return _strip_win(_diff_out(p, orig, dir, win, vis, t_pin, n_pin, rp=rp))

            _, vjp = jax.vjp(rf, packed, aa)
            gp, ga = vjp(_strip_win(g))
            return gp, jnp.zeros((), jnp.float32), ga

        f.defvjp(f_fwd, f_bwd)

        def run(packed, lin_base, aa_offset=(0.0, 0.0)):
            return f(
                packed,
                jnp.asarray(lin_base, jnp.float32).reshape(()),
                jnp.asarray(aa_offset, jnp.float32).reshape(2),
            )

        return run

    @jax.custom_vjp
    def f(packed, aa):
        o = kern(sg(packed), sg(aa))
        orig, dir = _gen_rays(sg(packed), width, height, sg(aa))
        return _fast_out(packed, orig, dir, o)

    def f_fwd(packed, aa):
        o = kern(sg(packed), sg(aa))
        so, sd = _gen_rays(sg(packed), width, height, sg(aa))
        return _fast_out(packed, so, sd, o), (packed, aa, _split(o))

    def f_bwd(res, g):
        packed, aa, (win, vis, t_pin, n_pin) = res
        so, sd = _gen_rays(sg(packed), width, height, sg(aa))
        rp = _pins_sg(packed, so, sd, win, t_pin, n_pin)

        def rf(p, a):
            orig, dir = _gen_rays(p, width, height, a)
            return _strip_win(_diff_out(p, orig, dir, win, vis, t_pin, n_pin, rp=rp))

        _, vjp = jax.vjp(rf, packed, aa)
        return vjp(_strip_win(g))

    f.defvjp(f_fwd, f_bwd)

    def run(packed, aa_offset=(0.0, 0.0)):
        return f(packed, jnp.asarray(aa_offset, jnp.float32).reshape(2))

    return run


def build_trace_round0(
    static: SceneStatic,
    width: int,
    height: int,
    interpret: bool = False,
    n_rays: int = None,
    want_hit: bool = False,
    lin_input: bool = False,
):
    """The fused-path round-0 factory every renderer builds through:
    ``build_diff_round0`` normally, the bump hybrid when the scene carries
    bump maps (``want_hit`` callers — the GI renderer — keep the plain
    kernel: GI ignores bump everywhere, like the oracle's pathtrace)."""
    if static.has_bump and not want_hit:
        return build_bump_round0(
            static, width, height, interpret, n_rays=n_rays, lin_input=lin_input
        )
    return build_diff_round0(
        static, width, height, interpret, n_rays=n_rays,
        want_hit=want_hit, lin_input=lin_input,
    )
