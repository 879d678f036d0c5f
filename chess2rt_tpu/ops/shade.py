"""Device-side texturing and direct shading (texture.d, shader.d).

Wavefront design: instead of per-node virtual dispatch, material and texture
parameters live in node-indexed tables (ScenePacked) and are *gathered* by
the per-ray winning-node id, so the whole batch shades in one fused pass —
in particular the shadow-visibility scan over nodes runs once per light for
the entire wavefront, not once per (node, ray) pair like the reference's
object graph (shader.d:80-103).

Texture kinds absent from the scene are statically skipped (SceneStatic
.tex_kinds_present), so e.g. a checker-only scene never touches the bitmap
atlas gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

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
from . import geometry as G


def _norm(v):
    return v / jnp.sqrt((v * v).sum(-1, keepdims=True))


def dot(a, b):
    return (a * b).sum(-1)


def faceforward(ray, norm):
    """imported_types.d:69-73: +norm towards the viewer, else -norm."""
    return jnp.where(dot(ray, norm)[..., None] < 0, norm, -norm)


def shadow_eps(dtype) -> float:
    """Self-intersection offset for shadow/secondary rays.  The reference
    uses 1e-6 in float64 (shader.d:88); under float32 that offset is below
    one ulp at the reference scenes' coordinate scale (~1e2), so the f32
    path widens it to 1e-3.  f64 keeps exact parity."""
    return 1e-6 if dtype == jnp.float64 else 1e-3


def static_select(winc, values, dtype=jnp.int32):
    """Per-ray lookup of a STATICALLY-known per-node value via a
    compare-select chain instead of a table gather.

    ``tab[winc]`` with a tiny device table lowers to a per-ray gather.
    The per-node values here (shader kind, texture kind, bitmap index)
    are Python constants, so a chain of ``where(winc == i, v_i, ...)``
    compiles to elementwise compares/selects that fuse with their
    neighbours, collapsing runs of equal values.  O(#distinct values)
    selects, zero gathers."""
    values = list(values)
    if not values:
        return jnp.zeros(winc.shape, dtype)
    out = jnp.full(winc.shape, values[0], dtype)
    for i, v in enumerate(values[1:], 1):
        if v != values[0]:
            out = jnp.where(winc == i, jnp.asarray(v, dtype), out)
    return out


def shader_kind_of(static: SceneStatic, winc):
    return static_select(winc, [n.shader_kind for n in static.nodes])


def tex_kind_of(static: SceneStatic, winc):
    return static_select(winc, [n.tex_kind for n in static.nodes])


def node_onehot(static: SceneStatic, winc):
    """[N, Nn] one-hot of the winning node id.

    Node-table lookups go through this as contractions (onehot @ table)
    instead of index-gathers: the VJP of a gather is a per-ray scatter-add
    with heavy index duplication, while the VJP of the contraction is a
    matmul.  Forward cost is negligible at scene-sized tables."""
    n_nodes = max(len(static.nodes), 1)
    return (winc[..., None] == jnp.arange(n_nodes)).astype(jnp.float32)


def node_gather(onehot, table):
    """Per-ray row of a [Nn, ...] node table via one-hot contraction."""
    flat = table.reshape(table.shape[0], -1)
    out = onehot.astype(table.dtype) @ flat
    return out.reshape(onehot.shape[:-1] + table.shape[1:])


# --------------------------------------------------------------------------
# Textures (texture.d:20-162, bitmap.d:48-63)
# --------------------------------------------------------------------------


def texture_color(packed: ScenePacked, static: SceneStatic, winc, u, v, onehot=None):
    """Per-ray diffuse color: flat material color or the node's texture.
    ``winc`` is the winning node id clipped to >= 0; node-table lookups go
    through the one-hot contraction (see node_onehot)."""
    if onehot is None:
        onehot = node_onehot(static, winc)
    tk = tex_kind_of(static, winc)
    out = node_gather(onehot, packed.mat_color)
    present = static.tex_kinds_present

    if TEX_CHECKER in present:
        size = node_gather(onehot, packed.checker_size)
        x = jnp.floor(u / size).astype(jnp.int32)
        y = jnp.floor(v / size).astype(jnp.int32)
        # D's signed %2 marks exactly the same squares as (x+y) & 1
        # (texture.d:48-53; see oracle tex_color for the equivalence).
        white = ((x + y) & 1).astype(bool)
        checker = jnp.where(
            white[..., None],
            node_gather(onehot, packed.checker_c2),
            node_gather(onehot, packed.checker_c1),
        )
        out = jnp.where((tk == TEX_CHECKER)[..., None], checker, out)

    if TEX_PROC2 in present:
        # sum_i colorU[i]*sin(u*freqU[i]) + colorV[i]*sin(v*freqV[i])
        # (texture.d:77-85), batched over the 3 bands.
        su = jnp.sin(u[..., None] * node_gather(onehot, packed.proc2_freq_u))  # [N, 3]
        sv = jnp.sin(v[..., None] * node_gather(onehot, packed.proc2_freq_v))
        proc = (node_gather(onehot, packed.proc2_color_u) * su[..., None]).sum(-2) + (
            node_gather(onehot, packed.proc2_color_v) * sv[..., None]
        ).sum(-2)
        out = jnp.where((tk == TEX_PROC2)[..., None], proc, out)

    if TEX_BITMAP in present:
        bil = bitmap_color(packed, static, winc, u, v, onehot)
        out = jnp.where((tk == TEX_BITMAP)[..., None], bil, out)

    return out


def bilerp_quad(g, p, q):
    """Bilinear blend of a gathered [.., 12] quad row (t00|t10|t01|t11)."""
    return (
        g[..., 0:3] * (1 - p) * (1 - q)
        + g[..., 3:6] * p * (1 - q)
        + g[..., 6:9] * (1 - p) * q
        + g[..., 9:12] * p * q
    )


def _quad_row_key(sizes, idx, idx_to_tex, ixi, iyi):
    """Per-ray row key into a ``_quad_atlas_flat`` table:
    ``base[t] + iy*w + ix`` with base the per-texture h*w prefix sums.
    ``idx`` is the per-lane select index, ``idx_to_tex`` the static
    texture id for each of its values.  Shared by the bitmap texel plan
    and the bump derivative sampler so the two quad-gather paths cannot
    drift."""
    bases = [0]
    for hh, wwid in sizes:
        bases.append(bases[-1] + hh * wwid)
    base = static_select(idx, [bases[t] for t in idx_to_tex])
    wi = static_select(idx, [sizes[t][1] if sizes else 1 for t in idx_to_tex])
    return base + iyi * wi + ixi


def bitmap_plan(packed: ScenePacked, static: SceneStatic, winc, u, v, onehot=None):
    """Bilinear bitmap sample PLAN: -> (quads2d, key, p, q) where quads2d is
    the flat quad table [rows, 12], key the per-ray flat row index, and
    (p, q) the bilinear fractions — so callers can merge this gather with
    others (the env cubemap) into ONE per-ray row gather
    (texture.d:103-162 scaling/wrap + bitmap.d:48-63 filtering)."""
    if onehot is None:
        onehot = node_onehot(static, winc)
    # texture row + true (h, w) via static compare-select chains — table
    # gathers here cost as much as the texel fetch itself (see
    # static_select); sizes come from the static bitmap_sizes, which the
    # packed bitmap_hw mirrors
    b = static_select(winc, [max(n.bitmap_idx, 0) for n in static.nodes])
    # only reachable with TEX_BITMAP present, so bitmap_sizes is non-empty
    h = static_select(b, [s[0] for s in static.bitmap_sizes], packed.bitmap_atlas.dtype)
    w = static_select(b, [s[1] for s in static.bitmap_sizes], packed.bitmap_atlas.dtype)
    scaling = node_gather(onehot, packed.bitmap_scaling)
    uu = u * scaling
    vv = v * scaling
    uu = uu - jnp.floor(uu)
    vv = vv - jnp.floor(vv)
    tx = uu * w
    ty = vv * h
    ix = jnp.clip(jnp.floor(tx), 0, w - 1)
    iy = jnp.clip(jnp.floor(ty), 0, h - 1)
    p = (tx - ix)[..., None]
    q = (ty - iy)[..., None]
    ixi = ix.astype(jnp.int32)
    iyi = iy.astype(jnp.int32)
    atlas = packed.bitmap_atlas
    if not static.train_textures:
        atlas = jax.lax.stop_gradient(atlas)
    # ONE 12-float gather per ray instead of 4 taps: quad[y, x] holds
    # the 2x2 bilinear neighbourhood with the reference's edge wrap
    # (bitmap.d:55-56), built in-graph so texel gradients stay exact.
    # The table is UNPADDED (concatenated true h*w blocks, not Hmax*Wmax),
    # so the gather and its cotangent scatter touch only true texels.
    quads2d = _quad_atlas_flat(atlas, static.bitmap_sizes)
    key = _quad_row_key(
        static.bitmap_sizes, winc,
        [max(n.bitmap_idx, 0) for n in static.nodes], ixi, iyi,
    )
    return quads2d, key, p, q


def bitmap_color(packed: ScenePacked, static: SceneStatic, winc, u, v, onehot=None):
    """Bilinear bitmap sample for the winning node's texture.

    Exposed standalone so the fused Pallas path (ops/pallas_trace.py) can
    defer exactly this gather to XLA: the kernel emits (win, u, v) and
    this function turns them into texels."""
    quads2d, key, p, q = bitmap_plan(packed, static, winc, u, v, onehot)
    g = quad_gather_flat(quads2d, key)  # [N, 12]
    return bilerp_quad(g, p, q)


# --------------------------------------------------------------------------
# Texel-gradient custom VJP
# --------------------------------------------------------------------------
#
# The VJP of the per-ray quad gather is a scatter-add of [N, 12] cotangents
# into the quad atlas, with heavy index duplication (many rays land on the
# same texel); the GPU runs it with float atomics.  Cotangents of
# out-of-range keys are dropped, not added to the clamped row.


def _f0(x):
    import numpy as np

    return np.zeros(x.shape, dtype=jax.dtypes.float0)


@jax.custom_vjp
def quad_gather_flat(table, key):
    """``table[key]`` for a flat [rows, C] quad table with the texel-grad
    scatter-add VJP.  Shared by the bitmap-atlas gather and the merged
    bitmap+cubemap gather."""
    return table[key]


def _qgf_fwd(table, key):
    # zero-width slice: carries the row count + dtype statically at no cost
    return table[key], (key, table[:, :0])


def _qgf_bwd(res, g):
    key, proto = res
    C = g.shape[-1]
    kf = key.reshape(-1)
    dq = jnp.zeros((proto.shape[0], C), g.dtype).at[kf].add(g.reshape(-1, C), mode="drop")
    return dq, _f0(key)


quad_gather_flat.defvjp(_qgf_fwd, _qgf_bwd)


def _quad_atlas_flat(atlas, sizes):
    """[T, Hmax, Wmax, C] padded atlas -> UNPADDED flat quad table
    [sum(h*w), 4C]: per texture, each row holds (t00, t10, t01, t11) of its
    2x2 neighbourhood with wrap-around; textures concatenate in order, so
    row keys are base[t] + y*w + x with base the h*w prefix sums."""
    C = atlas.shape[-1]
    rows = []
    for t, (h, w) in enumerate(sizes):
        img = atlas[t, :h, :w]
        x1 = jnp.roll(img, -1, axis=1)
        y1 = jnp.roll(img, -1, axis=0)
        xy1 = jnp.roll(x1, -1, axis=0)
        quad = jnp.concatenate([img, x1, y1, xy1], axis=-1)
        rows.append(quad.reshape(h * w, 4 * C))
    if not rows:
        return jnp.zeros((0, 4 * C), dtype=atlas.dtype)
    return rows[0] if len(rows) == 1 else jnp.concatenate(rows)


# --------------------------------------------------------------------------
# Bump mapping (extension; oracle/renderer.modify_normal is the ground truth)
# --------------------------------------------------------------------------


def apply_bump(packed: ScenePacked, static: SceneStatic, winc, hit, onehot=None):
    """Perturb hit normals by the winning node's bump map (the
    renderer.d:370-372 hook, completed by the BumpTexture extension):

        (dx, dy) = bilinear wrap sample of the differentiated map
        normal'  = normalize(normal + (dNdx*dx + dNdy*dy) * strength)

    Nodes without a bump map keep their normal.  Requires the hit records
    to carry dndx/dndy (scene_closest(..., tangents=True)).  The bump
    atlas is non-trainable (stop_gradient): its cotangent would be a
    scatter-add, and height-field optimization is not a supported leaf."""
    if not static.has_bump:
        return hit["normal"]
    if onehot is None:
        onehot = node_onehot(static, winc)
    b = static_select(winc, [max(n.bump_idx, 0) for n in static.nodes])
    hh = static_select(b, [s[0] for s in static.bump_sizes])
    ww = static_select(b, [s[1] for s in static.bump_sizes])
    h = hh.astype(packed.bump_atlas.dtype)
    w = ww.astype(packed.bump_atlas.dtype)
    scaling = node_gather(onehot, packed.bump_scaling)
    uu = hit["u"] * scaling
    vv = hit["v"] * scaling
    uu = uu - jnp.floor(uu)
    vv = vv - jnp.floor(vv)
    tx = uu * w
    ty = vv * h
    ix = jnp.clip(jnp.floor(tx), 0, w - 1)
    iy = jnp.clip(jnp.floor(ty), 0, h - 1)
    p = (tx - ix)[..., None]
    q = (ty - iy)[..., None]
    # ONE [rows, 8] quad-row gather instead of 4 separate taps — the same
    # bilinear-texturing lever as bitmap_plan.  The quad
    # table is UNPADDED (per-texture h*w rows) with the
    # wrap-around neighbourhood baked in, matching the % wraps below; only
    # the dx/dy channels are carried (differentiate's blue is always 0).
    # stop_gradient atlas -> the non-differentiable raw path is safe.
    atlas = jax.lax.stop_gradient(packed.bump_atlas)
    quads = _quad_atlas_flat(atlas[..., :2], static.bump_sizes)  # [R, 8]
    ixi = ix.astype(jnp.int32)
    iyi = iy.astype(jnp.int32)
    key = _quad_row_key(
        static.bump_sizes, b, list(range(len(static.bump_sizes))), ixi, iyi
    )
    g = quads[key]
    d = (
        g[..., 0:2] * (1 - p) * (1 - q)
        + g[..., 2:4] * p * (1 - q)
        + g[..., 4:6] * (1 - p) * q
        + g[..., 6:8] * p * q
    )
    strength = node_gather(onehot, packed.bump_strength)
    dn = (hit["dndx"] * d[..., 0:1] + hit["dndy"] * d[..., 1:2]) * strength[..., None]
    bumped = G._norm(hit["normal"] + dn)  # guarded: dead lanes stay NaN-free
    has = static_select(winc, [1 if n.bump_idx >= 0 else 0 for n in static.nodes]).astype(bool)
    return jnp.where(has[..., None], bumped, hit["normal"])


# --------------------------------------------------------------------------
# Direct shading: fused Lambert + Phong (shader.d:67-105, :197-250)
# --------------------------------------------------------------------------


def shade_direct(packed: ScenePacked, static: SceneStatic, ray_dir, hit, winc, geom_normal=None):
    """Direct lighting for the whole wavefront in one pass.

    Lambert: diffuse * (ambient + sum_lights visible * lightColor/d^2 * cos)
    Phong adds the untinted cos^n specular (shader.d:246-249); the specular
    term is masked to Phong-shaded rays via a static select chain.

    ``geom_normal``: the pre-bump GEOMETRIC normal for the shadow-origin
    offset when the BumpTexture extension perturbed hit["normal"] — bump
    is a shading-normal trick, visibility rays offset along the geometric
    surface (matches the fused kernel's in-kernel shadow scans and the
    oracle, see oracle/renderer._direct_light)."""
    skind = shader_kind_of(static, winc)
    onehot = node_onehot(static, winc)
    N = faceforward(ray_dir, hit["normal"])
    diffuse = texture_color(packed, static, winc, hit["u"], hit["v"], onehot)

    has_phong = PHONG in static.shader_kinds_present
    lam = jnp.zeros_like(hit["p"])
    spec = jnp.zeros_like(hit["p"]) if has_phong else None
    eps = shadow_eps(ray_dir.dtype)
    Ng = N if geom_normal is None else faceforward(ray_dir, geom_normal)
    shade_from = hit["p"] + Ng * eps

    for li in range(static.n_lights):
        lp = packed.light_pos[li]
        lc = packed.light_color[li] * packed.light_power[li]
        # lightColor.intensity() != 0 gate (shader.d:88)
        nonzero = lc.mean() != 0
        vis = G.test_visibility(packed, static, shade_from, jnp.broadcast_to(lp, shade_from.shape))
        vis &= nonzero
        # named so the remat policy stores the boolean mask instead of
        # re-running the whole any-hit scan in the backward pass (the
        # scan's own VJP is zero — comparisons only); see _run_rounds
        from jax.ad_checkpoint import checkpoint_name

        vis = checkpoint_name(vis, "shadow_vis")
        to_light = lp - hit["p"]
        light_dir = _norm(to_light)
        cos_theta = dot(light_dir, N)
        base = lc / dot(to_light, to_light)[..., None]
        lam = lam + jnp.where((vis & (cos_theta > 0))[..., None], base * cos_theta[..., None], 0.0)
        if has_phong:
            # R = reflect(-lightDir, N) is normalized (imported_types.d:62-67)
            R = _norm(-light_dir - 2.0 * dot(-light_dir, N)[..., None] * N)
            cos_gamma = dot(R, -ray_dir)
            exponent = node_gather(onehot, packed.mat_exponent)
            strength = node_gather(onehot, packed.mat_strength)
            s = base * jnp.power(jnp.maximum(cos_gamma, 0.0), exponent)[..., None]
            s = s * strength[..., None]
            spec = spec + jnp.where((vis & (cos_gamma > 0))[..., None], s, 0.0)

    out = diffuse * (packed.ambient + lam)
    if has_phong:
        out = out + jnp.where((skind == PHONG)[..., None], spec, 0.0)
    return out
