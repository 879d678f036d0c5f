"""ScenePacked: the device-side differentiable scene representation.

The reference's object graph (Node -> Geometry/Shader/Texture, scene.d:38-96)
becomes two things:

* ``ScenePacked`` — a registered JAX pytree of SoA arrays.  Every float in it
  is a differentiable leaf: geometry parameters, node transforms, light and
  material tables, camera parameters, texture params and bitmap texels.
* ``SceneStatic`` — hashable static structure: per-node CSG expression trees,
  shader/texture kinds, frame size and engine knobs.  This is what the
  render functions close over / receive as a static argument, so XLA traces
  exactly the code the scene needs (absent texture kinds cost nothing).

Geometry expressions (``GeomExpr``) are nested tuples:
    ("plane", i) | ("sphere", i) | ("cube", i)
    ("csg", op, left_expr, right_expr)        op in {"union","inter","diff"}
with ``i`` indexing the per-kind parameter tables.

Name->index maps stay host-side (SURVEY.md §7.0).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import vec
from . import types as T

# shader kinds
LAMBERT, PHONG, REFLECTION, REFRACTION = 0, 1, 2, 3
# texture kinds
TEX_NONE, TEX_CHECKER, TEX_PROC2, TEX_BITMAP = 0, 1, 2, 3

_SHADER_KIND = {T.Lambert: LAMBERT, T.Phong: PHONG, T.Reflection: REFLECTION, T.Refraction: REFRACTION}


@jax.tree_util.register_dataclass
@dataclass
class CameraPacked:
    """Differentiable camera parameters (camera.d:29-53)."""

    pos: Any
    yaw: Any
    pitch: Any
    roll: Any
    fov: Any
    focal_plane_dist: Any
    disc_multiplier: Any
    stereo_separation: Any


@jax.tree_util.register_dataclass
@dataclass
class ScenePacked:
    """SoA parameter tables.  Empty kinds hold shape-(0, ...) arrays."""

    # leaf geometry tables
    plane_y: Any
    plane_limit: Any
    sphere_center: Any  # [Ns, 3]
    sphere_r: Any
    cube_center: Any  # [Nc, 3]
    cube_side: Any

    # node transforms (node.d, transform.d); inverses are derived in-graph
    node_matrix: Any  # [Nn, 3, 3]
    node_offset: Any  # [Nn, 3]

    # lights (light.d:52-89)
    light_pos: Any  # [L, 3]
    light_color: Any  # [L, 3]
    light_power: Any  # [L]

    # material table indexed by node id
    mat_color: Any  # [Nn, 3]
    mat_exponent: Any  # [Nn]
    mat_strength: Any  # [Nn]
    mat_ior: Any  # [Nn]

    # texture parameter tables indexed by node id (zeros where unused)
    checker_c1: Any  # [Nn, 3]
    checker_c2: Any  # [Nn, 3]
    checker_size: Any  # [Nn]
    proc2_color_u: Any  # [Nn, 3, 3]
    proc2_color_v: Any  # [Nn, 3, 3]
    proc2_freq_u: Any  # [Nn, 3]
    proc2_freq_v: Any  # [Nn, 3]
    bitmap_scaling: Any  # [Nn]

    # stacked bitmap atlas [Tb, Hmax, Wmax, 3] (linear float) + true sizes
    bitmap_atlas: Any
    bitmap_hw: Any  # [Tb, 2] float (h, w) — float so UV scaling stays traced

    # bump-map extension (models/types.BumpTexture): differentiated
    # derivative maps [Tp, Hmax, Wmax, 3] + per-node scaling/strength
    bump_atlas: Any
    bump_scaling: Any  # [Nn]
    bump_strength: Any  # [Nn]

    # environment cubemap [6, S, S, 3] (zeros-shaped [0,1,1,3] when absent)
    env_cubemap: Any

    ambient: Any  # [3]
    camera: CameraPacked

    @property
    def dtype(self):
        return self.node_matrix.dtype


@dataclass(frozen=True)
class NodeStatic:
    geom: Tuple  # GeomExpr
    shader_kind: int
    tex_kind: int
    bitmap_idx: int  # row in the atlas (-1 if not a bitmap texture)
    identity_transform: bool
    offset_only: bool
    bump_idx: int = -1  # row in the bump atlas (-1 = no bump map)


@dataclass(frozen=True)
class SceneStatic:
    """Hashable structure + engine knobs (global_settings.d:5-78)."""

    nodes: Tuple[NodeStatic, ...]
    n_lights: int
    width: int
    height: int
    has_env: bool = False
    # true (h, w) per bitmap atlas row — static so the in-graph quad
    # construction (ops/shade.py) can wrap at real texture edges
    bitmap_sizes: Tuple[Tuple[int, int], ...] = ()
    # true (h, w) per bump atlas row (BumpTexture extension)
    bump_sizes: Tuple[Tuple[int, int], ...] = ()
    max_trace_depth: int = 4
    aa_enabled: bool = True
    # EXTENSION (GlobalSettings.adaptiveAA): honor the needs-AA mask the
    # reference computes and ignores (renderer.d:150-186) — resample only
    # flagged pixels.  Detection keeps tooDifferent's default 0.1
    # threshold (the AAThreshold-never-forwarded quirk, renderer.d:172).
    aa_adaptive: bool = False
    # fused adaptive-AA path: flagged pixels LANE-compact into this many
    # lanes for the 4 extra taps (None = frame_pixels // 32; tap rays are
    # pure arithmetic in the flagged index, so compaction needs no data
    # gathers — unlike the bounce rounds, where block granularity won);
    # overflow lax.cond-falls-back to full-width taps + mask select
    aa_capacity: Optional[int] = None
    dof: bool = False
    dof_samples: int = 25
    gi_enabled: bool = False
    paths_per_pixel: int = 40
    stereo: bool = False
    # extensions / quirk switches (documented in oracle/renderer.py)
    gi_multiplier_quirk: bool = True
    gi_point_light_direct: bool = False
    # forward-only speed switch: early-exit while_loop over wavefront rounds
    # (not reverse-differentiable; see trace_whitted)
    fast_forward: bool = False
    # opt-in compensated (df32 two-float, ~f64-emulated) camera ray-gen for
    # the f32 XLA pipeline: corners + per-pixel interpolation carry ~48-bit
    # significands and the direction is rounded to f32 last, killing the
    # 1-2 ulp corner errors the 1/dir.y horizon amplification (~700x on
    # lecture5) turns into whole-texel UV errors (ops/camera._begin_frame_df,
    # round-4 VERDICT item 5).  Default off: the default path's perf and
    # bit-exact outputs are unchanged.
    compensated_raygen: bool = False
    # bound peak device memory: render the pixel batch in lax.map slabs of
    # this many rays (None = whole frame at once); honored by the XLA
    # pipeline (render_frame), by the fused renderer in the deterministic,
    # DoF/stereo MC and GI paths (slabs through slab-width kernels), and
    # PER SHARD under the mesh (parallel/mesh.py)
    chunk_pixels: Optional[int] = None
    # wavefront compaction (fast_forward only): bounce rounds 1+ run on a
    # compacted ray buffer of this many lanes when the live set fits
    # (lax.cond falls back to full width when it doesn't); None = off
    bounce_capacity: Optional[int] = None
    # fused-kernel bounce strategy (build_flagship_renderer):
    # "compact" re-enters the ray-input kernel at bounce_capacity width
    # (sort + gather + scatter-back of individual lanes); "full"
    # re-enters it at full frame width with an all-dead cond-skip and no
    # compaction machinery; "block" (default) compacts whole 128-lane
    # blocks (the continuation set is spatially clustered), so the
    # compaction sort runs over n/128 keys and the writeback is a handful
    # of unique block-row adds while the rounds still run near-compacted
    # width; needs no bounce_capacity and falls back when n % 128 != 0
    bounce_mode: str = "block"
    # "block" capacity in 128-lane blocks (None = frame_blocks/12);
    # overflow lax.cond-falls-back to full width
    bounce_block_capacity: Optional[int] = None
    # GI path tracing: evaluate this many MC paths per kernel launch
    # (lanes = batch x pixels).  The RNG key chains are unrolled exactly
    # (every lane draws the same uniforms as the sequential scan; only
    # the f32 accumulation order changes).  A batch runs round r if ANY of
    # its paths is alive, so per-path dead-round skips are lost.  Default 1.
    gi_path_batch: Optional[int] = None
    # Rematerialize each GI path iteration in the backward pass
    # (jax.checkpoint around the paths_per_pixel scan body): reverse-mode
    # AD otherwise stacks every bounce round's [n, 3] residuals x
    # paths_per_pixel.  Costs one extra forward per path in the backward;
    # value-identical.
    gi_remat_paths: bool = False
    # False stops gradients at the bitmap texel atlas (its VJP is a
    # per-ray scatter-add); disable when texels aren't being optimized
    train_textures: bool = True
    # AA-tap texel-gather reuse (default False): each AA tap reuses the
    # base tap's gathered [n, 12] quads and re-gathers only changed-key
    # lanes (lane-compacted: one n-key sort + small row gather +
    # scatter-set; bit-identical, overflow cond-falls back to the full
    # gather).  The premise "sub-pixel offsets rarely change the quad"
    # holds only for MAGNIFIED textures; minified ones (a horizon floor)
    # change key on a large share of lanes per tap.
    texel_tap_reuse: bool = False
    # changed-lane capacity per tap (None = frame_pixels // 8)
    texel_reuse_capacity: Optional[int] = None
    # render through the fused Pallas kernel when the scene is supported
    # (ops/pallas_trace.supports) and the backend compiles it (the GPU;
    # see chess2rt_tpu/dispatch.py); differentiable via the custom-VJP
    # wrapper (ops/pallas_grad.py), so inverse rendering dispatches too.
    # False forces the XLA wavefront (the reference path for A/B checks)
    use_pallas: bool = True
    # run the fused kernel in the Pallas interpreter on the CPU (tests);
    # ignored on the GPU, which always runs the compiled kernel
    interpret_pallas: bool = False
    # rematerialize wavefront rounds in the backward pass (jax.checkpoint):
    # recompute is cheap relative to holding every round's residuals
    remat_rounds: bool = True

    @property
    def tex_kinds_present(self):
        return frozenset(n.tex_kind for n in self.nodes)

    @property
    def shader_kinds_present(self):
        return frozenset(n.shader_kind for n in self.nodes)

    @property
    def has_bump(self) -> bool:
        return any(n.bump_idx >= 0 for n in self.nodes)

    @property
    def inf_dist(self) -> float:
        return 1e30  # f32-safe stand-in for the reference's 1e99 seed


def leaf_table(static: SceneStatic):
    """Global enumeration of geometry LEAVES in left-then-right traversal
    order: returns (leaves, node_base) with leaves[g] = (node_idx, kind,
    table_idx) and node_base[i] = global id of node i's first leaf.

    The leaf-pinned custom-VJP backward (ops/pallas_grad.py) matches the
    fused kernel's saved winning-hit t against each leaf's closed-form
    candidate solutions under this numbering, then reconstructs the
    winning primitive's partials in closed form — no CSG re-walk, no
    per-node all-hits sort networks in the backward."""
    leaves = []
    node_base = []
    for i, ns in enumerate(static.nodes):
        node_base.append(len(leaves))

        def walk(e, i=i):
            if e[0] == "csg":
                walk(e[2])
                walk(e[3])
            else:
                leaves.append((i, e[0], e[1]))

        walk(ns.geom)
    return leaves, node_base


def max_hits(expr: Tuple) -> int:
    """Static per-ray hit capacity of a geometry expression (SURVEY.md §7.2)."""
    if expr[0] == "plane":
        return 1
    if expr[0] in ("sphere", "cube"):
        return 2
    return max_hits(expr[2]) + max_hits(expr[3])


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------


def _geom_expr(geom: T.Geometry, tables) -> Tuple:
    if isinstance(geom, T.Plane):
        key = id(geom)
        if key not in tables["geom_ids"]:
            tables["geom_ids"][key] = len(tables["plane_y"])
            tables["plane_y"].append(geom.y)
            tables["plane_limit"].append(geom.limit if np.isfinite(geom.limit) else 1e30)
        return ("plane", tables["geom_ids"][key])
    if isinstance(geom, T.Sphere):
        key = id(geom)
        if key not in tables["geom_ids"]:
            tables["geom_ids"][key] = len(tables["sphere_r"])
            tables["sphere_center"].append(geom.center)
            tables["sphere_r"].append(geom.R)
        return ("sphere", tables["geom_ids"][key])
    if isinstance(geom, T.Cube):
        key = id(geom)
        if key not in tables["geom_ids"]:
            tables["geom_ids"][key] = len(tables["cube_side"])
            tables["cube_center"].append(geom.center)
            tables["cube_side"].append(geom.side)
        return ("cube", tables["geom_ids"][key])
    if isinstance(geom, T.CsgOp):
        left = _geom_expr(geom.left, tables)
        right = _geom_expr(geom.right, tables)
        return ("csg", geom.op, left, right)
    raise TypeError(type(geom))


def pack_scene(scene: T.Scene, dtype=jnp.float32) -> Tuple[ScenePacked, SceneStatic]:
    """Scene (host object model) -> (ScenePacked, SceneStatic)."""
    tables = {
        "geom_ids": {},
        "plane_y": [],
        "plane_limit": [],
        "sphere_center": [],
        "sphere_r": [],
        "cube_center": [],
        "cube_side": [],
    }

    nn = len(scene.nodes)
    node_static = []
    node_matrix = np.zeros((nn, 3, 3))
    node_offset = np.zeros((nn, 3))
    mat_color = np.ones((nn, 3), dtype=np.float32)
    mat_exponent = np.ones(nn, dtype=np.float32)
    mat_strength = np.ones(nn, dtype=np.float32)
    mat_ior = np.full(nn, 1.33, dtype=np.float32)
    checker_c1 = np.zeros((nn, 3), dtype=np.float32)
    checker_c2 = np.zeros((nn, 3), dtype=np.float32)
    checker_size = np.ones(nn, dtype=np.float32)
    proc2_cu = np.zeros((nn, 3, 3), dtype=np.float32)
    proc2_cv = np.zeros((nn, 3, 3), dtype=np.float32)
    proc2_fu = np.zeros((nn, 3), dtype=np.float32)
    proc2_fv = np.zeros((nn, 3), dtype=np.float32)
    bitmap_scaling = np.ones(nn, dtype=np.float32)
    bump_scaling = np.ones(nn, dtype=np.float32)
    bump_strength = np.zeros(nn, dtype=np.float32)

    bitmaps = []  # unique BitmapTexture.data arrays
    bitmap_ids = {}
    bumps = []  # unique differentiated BumpTexture derivative maps
    bump_ids = {}

    for i, node in enumerate(scene.nodes):
        expr = _geom_expr(node.geometry, tables)
        tr = node.transform
        node_matrix[i] = tr.matrix
        node_offset[i] = tr.offset
        ident = bool(np.allclose(tr.matrix, np.eye(3)) and np.allclose(tr.offset, 0))
        offset_only = bool(np.allclose(tr.matrix, np.eye(3)))

        sh = node.shader
        kind = _SHADER_KIND[type(sh)]
        mat_color[i] = np.asarray(sh.color, dtype=np.float32)
        if isinstance(sh, T.Phong):
            mat_exponent[i] = sh.exponent
            mat_strength[i] = sh.strength
        if isinstance(sh, T.Refraction):
            mat_ior[i] = sh.ior

        tex = getattr(sh, "texture", None)
        tex_kind, bidx = TEX_NONE, -1
        if isinstance(tex, T.Checker):
            tex_kind = TEX_CHECKER
            checker_c1[i] = tex.color1
            checker_c2[i] = tex.color2
            checker_size[i] = tex.size
        elif isinstance(tex, T.Procedure2):
            tex_kind = TEX_PROC2
            proc2_cu[i] = np.asarray(tex.colorU, dtype=np.float32)
            proc2_cv[i] = np.asarray(tex.colorV, dtype=np.float32)
            proc2_fu[i] = np.asarray(tex.freqU, dtype=np.float32)
            proc2_fv[i] = np.asarray(tex.freqV, dtype=np.float32)
        elif isinstance(tex, T.BitmapTexture):
            tex_kind = TEX_BITMAP
            key = id(tex)
            if key not in bitmap_ids:
                bitmap_ids[key] = len(bitmaps)
                bitmaps.append(np.asarray(tex.data, dtype=np.float32))
            bidx = bitmap_ids[key]
            bitmap_scaling[i] = tex.scaling

        # bump-map extension: only the BumpTexture subclass perturbs
        # normals (the reference's modifyNormal hook is a no-op for every
        # other texture kind — texture.d:10-12)
        pidx = -1
        if isinstance(node.bumpmap, T.BumpTexture):
            from ..imageio import differentiate

            key = id(node.bumpmap)
            if key not in bump_ids:
                bump_ids[key] = len(bumps)
                bumps.append(differentiate(np.asarray(node.bumpmap.data, dtype=np.float32)))
            pidx = bump_ids[key]
            bump_scaling[i] = node.bumpmap.scaling
            bump_strength[i] = node.bumpmap.strength

        node_static.append(
            NodeStatic(
                geom=expr,
                shader_kind=kind,
                tex_kind=tex_kind,
                bitmap_idx=bidx,
                identity_transform=ident,
                offset_only=offset_only,
                bump_idx=pidx,
            )
        )

    # Pad bitmaps into one atlas so a per-ray texture id can gather rows.
    if bitmaps:
        hmax = max(b.shape[0] for b in bitmaps)
        wmax = max(b.shape[1] for b in bitmaps)
        atlas = np.zeros((len(bitmaps), hmax, wmax, 3), dtype=np.float32)
        hw = np.zeros((len(bitmaps), 2), dtype=np.float32)
        for j, b in enumerate(bitmaps):
            atlas[j, : b.shape[0], : b.shape[1]] = b
            hw[j] = (b.shape[0], b.shape[1])
    else:
        atlas = np.zeros((0, 1, 1, 3), dtype=np.float32)
        hw = np.zeros((0, 2), dtype=np.float32)

    if bumps:
        phmax = max(b.shape[0] for b in bumps)
        pwmax = max(b.shape[1] for b in bumps)
        bump_atlas = np.zeros((len(bumps), phmax, pwmax, 3), dtype=np.float32)
        for j, b in enumerate(bumps):
            bump_atlas[j, : b.shape[0], : b.shape[1]] = b
    else:
        bump_atlas = np.zeros((0, 1, 1, 3), dtype=np.float32)

    lights = scene.lights
    cam = scene.camera
    s = scene.settings
    f = lambda x: jnp.asarray(x, dtype=dtype)  # noqa: E731

    packed = ScenePacked(
        plane_y=f(tables["plane_y"]),
        plane_limit=f(tables["plane_limit"]),
        sphere_center=f(np.asarray(tables["sphere_center"], dtype=np.float64).reshape(-1, 3)),
        sphere_r=f(tables["sphere_r"]),
        cube_center=f(np.asarray(tables["cube_center"], dtype=np.float64).reshape(-1, 3)),
        cube_side=f(tables["cube_side"]),
        node_matrix=f(node_matrix),
        node_offset=f(node_offset),
        light_pos=f(np.asarray([li.pos for li in lights], dtype=np.float64).reshape(-1, 3)),
        light_color=f(np.asarray([li.color for li in lights], dtype=np.float64).reshape(-1, 3)),
        light_power=f([li.power for li in lights]),
        mat_color=f(mat_color),
        mat_exponent=f(mat_exponent),
        mat_strength=f(mat_strength),
        mat_ior=f(mat_ior),
        checker_c1=f(checker_c1),
        checker_c2=f(checker_c2),
        checker_size=f(checker_size),
        proc2_color_u=f(proc2_cu),
        proc2_color_v=f(proc2_cv),
        proc2_freq_u=f(proc2_fu),
        proc2_freq_v=f(proc2_fv),
        bitmap_scaling=f(bitmap_scaling),
        bitmap_atlas=f(atlas),
        bitmap_hw=f(hw),
        bump_atlas=f(bump_atlas),
        bump_scaling=f(bump_scaling),
        bump_strength=f(bump_strength),
        env_cubemap=f(
            scene.environment.cubemap
            if scene.environment.cubemap is not None
            else np.zeros((0, 1, 1, 3), dtype=np.float32)
        ),
        ambient=f(s.ambientLightColor),
        camera=CameraPacked(
            pos=f(cam.pos),
            yaw=f(cam.yaw),
            pitch=f(cam.pitch),
            roll=f(cam.roll),
            fov=f(cam.fov),
            focal_plane_dist=f(cam.focalPlaneDist),
            disc_multiplier=f(cam.discMultiplier),
            stereo_separation=f(cam.stereoSeparation),
        ),
    )

    static = SceneStatic(
        nodes=tuple(node_static),
        n_lights=len(lights),
        width=s.frameWidth,
        height=s.frameHeight,
        has_env=scene.environment.cubemap is not None,
        bitmap_sizes=tuple((b.shape[0], b.shape[1]) for b in bitmaps),
        bump_sizes=tuple((b.shape[0], b.shape[1]) for b in bumps),
        max_trace_depth=s.maxTraceDepth,
        aa_enabled=s.AAEnabled,
        aa_adaptive=getattr(s, "adaptiveAA", False),
        compensated_raygen=getattr(s, "compensatedRayGen", False),
        dof=cam.dof,
        dof_samples=cam.numSamples,
        gi_enabled=s.GIEnabled,
        paths_per_pixel=s.pathsPerPixel,
        stereo=cam.stereoSeparation != 0.0,
    )
    return packed, static
