"""The device render pipeline: fixed-depth wavefront under one jit.

Maps the reference's 3-pass recursive renderer (renderer.d:83-189, :325-463)
onto XLA-friendly structure:

* recursion -> K = maxTraceDepth statically-unrolled wavefront rounds over
  the full ray batch with an ``alive`` mask (SURVEY.md §7.0: wavefront, not
  megakernel).  Reference scenes carry only Lambert/Phong, so round 0
  terminates everything — the extension Reflection/Refraction shaders
  exercise the depth-K machinery (models/types.py docstring).
* buckets -> one flat pixel batch; sharding over a device mesh happens one
  level up (parallel/).
* the AA pass: the reference *computes* a needs-AA mask (renderer.d:150-178)
  but then unconditionally resamples every pixel (renderer.d:183-186 calls
  renderPixelAA for all x, y — the mask is never read).  We reproduce the
  observable behavior: with AAEnabled every pixel is the average of 5
  samples at the fixed kernel offsets (renderer.d:235-242).
* stochastic features (DoF disc sampling, GI hemisphere sampling, per-pass
  jitter) use jax.random threefry keyed per (sample, purpose) — the
  reference is seeded by wall-clock time (util/random.d:7-10) so these only
  match statistically.

Everything is differentiable end-to-end w.r.t. ScenePacked leaves.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..dispatch import INTERPRET, XLA, kernel_mode, note_xla_coverage
from ..models.packed import (
    LAMBERT,
    PHONG,
    REFLECTION,
    REFRACTION,
    ScenePacked,
    SceneStatic,
    pack_scene,
)
from ..ops import geometry as G
from ..ops import shade as S
from ..ops.camera import begin_frame, screen_rays

INF = G.INF


def _norm(v):
    return v / jnp.sqrt((v * v).sum(-1, keepdims=True))


def dot(a, b):
    return (a * b).sum(-1)


# --------------------------------------------------------------------------
# Whitted trace (renderer.d:325-376)
# --------------------------------------------------------------------------


def _whitted_round(packed, static, color, atten, alive, orig, dir, recursive, stats=None, r=0):
    """One wavefront round: closest-hit, direct shade, spawn continuation.
    Returns the updated carry.  Shared by the unrolled, scan and while_loop
    drivers below."""
    eps = S.shadow_eps(orig.dtype)
    hit, win = G.scene_closest(packed, static, orig, dir, tangents=static.has_bump)
    hitmask = alive & (win >= 0)
    winc = jnp.maximum(win, 0)
    geom_normal = None
    if static.has_bump:
        # bump hook site (renderer.d:370-372): perturb the winning normal
        # before shading AND before the continuation spawn below; the
        # geometric normal is kept for the shadow-origin offset
        geom_normal = hit["normal"]
        hit = dict(hit, normal=S.apply_bump(packed, static, winc, hit))
    skind = S.shader_kind_of(static, winc)

    direct = S.shade_direct(packed, static, dir, hit, winc, geom_normal)
    is_direct = (skind == LAMBERT) | (skind == PHONG)
    color = color + atten * jnp.where((hitmask & is_direct)[..., None], direct, 0.0)
    # miss -> environment: black in the reference (environment.d:5-15);
    # cubemap skybox when the scene provides one (ops/env.py extension)
    if static.has_env:
        from ..ops.env import sample_cubemap

        env = sample_cubemap(packed.env_cubemap, dir)
        color = color + atten * jnp.where((alive & (win < 0))[..., None], env, 0.0)

    if stats is not None:
        stats["shadow"] = stats.get("shadow", 0.0) + (hitmask & is_direct).sum() * static.n_lights
        if r > 0:
            stats["bounce"] = stats.get("bounce", 0.0) + alive.sum()

    if not recursive:
        return color, atten, jnp.zeros_like(alive), orig, dir

    onehot = S.node_onehot(static, winc)
    N = S.faceforward(dir, hit["normal"])
    refl_dir = _norm(dir - 2.0 * dot(dir, N)[..., None] * N)
    new_orig = hit["p"] + N * eps
    new_dir = refl_dir

    if REFRACTION in static.shader_kinds_present:
        ior = S.node_gather(onehot, packed.mat_ior)
        cos_in = -dot(dir, hit["normal"])
        entering = cos_in > 0
        eta = jnp.where(entering, 1.0 / ior, ior)
        n_face = jnp.where(entering[..., None], hit["normal"], -hit["normal"])
        ci = jnp.abs(cos_in)
        k = 1.0 - eta * eta * (1.0 - ci * ci)
        tir = k < 0
        # _safe_sqrt: clamped derivative at the TIR boundary k = 0 (an
        # exactly-critical-angle lane otherwise sends inf through the VJP)
        refr = eta[..., None] * dir + (eta * ci - G._safe_sqrt(jnp.maximum(k, 0.0)))[..., None] * n_face
        refr_dir = jnp.where(tir[..., None], refl_dir, _norm(refr))
        refr_orig = jnp.where(tir[..., None], hit["p"] + n_face * eps, hit["p"] - n_face * eps)
        is_refr = skind == REFRACTION
        new_dir = jnp.where(is_refr[..., None], refr_dir, new_dir)
        new_orig = jnp.where(is_refr[..., None], refr_orig, new_orig)

    continuing = hitmask & ((skind == REFLECTION) | (skind == REFRACTION))
    atten = atten * jnp.where(continuing[..., None], S.node_gather(onehot, packed.mat_color), 1.0)
    orig = jnp.where(continuing[..., None], new_orig, orig)
    dir = jnp.where(continuing[..., None], new_dir, dir)
    return color, atten, continuing, orig, dir


def trace_whitted(packed: ScenePacked, static: SceneStatic, orig, dir, stats=None):
    """Returns radiance [N, 3] for a batch of primary rays.

    Driver selection (SURVEY.md §7.2 'wavefront efficiency'):
    * non-recursive scene -> single straight-line round;
    * stats requested -> statically unrolled rounds (the bench harness reads
      per-round counters);
    * static.fast_forward -> lax.while_loop with an any(alive) early exit —
      dead wavefront rounds cost nothing, but reverse-mode AD through
      while_loop is unsupported, so this is the forward/bench path only;
    * default -> lax.scan over maxTraceDepth+1 rounds: one compiled round
      body (small HLO) and reverse-differentiable for inverse rendering.

    ``stats`` (optional dict) accumulates traced-ray counts: "camera"
    primary rays, "shadow" visibility rays (one per lit shading point per
    light, shader.d:88), "bounce" continuation rays."""
    recursive = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    rounds = (static.max_trace_depth + 1) if recursive else 1

    carry = (
        jnp.zeros_like(orig),  # color
        jnp.ones_like(orig),  # attenuation (BRDF product)
        jnp.ones(orig.shape[:-1], dtype=bool),  # alive
        orig,
        dir,
    )
    if stats is not None:
        stats["camera"] = stats.get("camera", 0.0) + float(np.prod(orig.shape[:-1]))

    if not recursive or stats is not None:
        for r in range(rounds):
            carry = _whitted_round(packed, static, *carry, recursive, stats, r)
            if not recursive:
                break
        return carry[0]

    n = int(np.prod(orig.shape[:-1]))
    cap = static.bounce_capacity
    if not cap or cap >= n or orig.ndim != 2:
        return _run_rounds(packed, static, carry, rounds)[0]

    # Round 0 at full width, then hand the live set to the shared
    # compaction driver (also used by the fused Pallas round-0 path).
    carry = _whitted_round(packed, static, *carry, True)
    return continue_bounces(packed, static, *carry, n_rounds=rounds - 1)


def _run_rounds(packed, static, carry, n_rounds):
    """Remaining wavefront rounds: early-exit while_loop when forward-only,
    reverse-differentiable lax.scan otherwise."""
    if static.fast_forward:

        def cond(state):
            r, (_, _, alive, _, _) = state
            return (r < n_rounds) & alive.any()

        def body(state):
            r, c = state
            return r + 1, _whitted_round(packed, static, *c, True)

        _, out = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
        return out

    def one_round(c):
        # differentiable early exit: a round with an all-dead wavefront is
        # exactly the identity (every contribution is alive-masked), so
        # skip its compute — and its backward — with a cond.  A cond
        # executes only the taken branch, and is reverse-differentiable, which
        # lax.while_loop's early exit is not.
        return jax.lax.cond(
            c[2].any(),
            lambda c: _whitted_round(packed, static, *c, True),
            lambda c: c,
            c,
        )

    if static.remat_rounds:
        # Without remat, each scan step stores its residuals for the
        # backward.  The policy keeps the shadow-visibility booleans (checkpoint_name in
        # shade_direct): they are cheap to store, their producers (the
        # per-light any-hit scans) have zero VJP, and saving them removes
        # those scans from the backward recompute entirely.
        one_round = jax.checkpoint(
            one_round,
            policy=jax.checkpoint_policies.save_only_these_names("shadow_vis"),
        )

    def scan_body(c, _):
        return one_round(c), None

    out, _ = jax.lax.scan(scan_body, carry, None, length=n_rounds)
    return out


def compact_indices(alive, n: int, cap: int):
    """sel[j] = flat index of the j-th live lane in ascending order (junk
    slots past the live count hold the out-of-range sentinel ``n``;
    callers mask values with ``arange(cap) < count`` and the sentinel
    makes scatters drop / gathers clamp harmlessly).

    Built as ONE lax.sort: sorting the live-index keys IS the compaction
    (no cumsum + drop-guarded scatter-set, no searchsorted)."""
    keys = jnp.where(alive, jnp.arange(n, dtype=jnp.int32), n)
    out = jax.lax.sort(keys)
    if cap <= n:
        return out[:cap]
    # tile-rounded capacities can exceed tiny frames: pad with the sentinel
    return jnp.concatenate([out, jnp.full(cap - n, n, jnp.int32)])


def continue_bounces(packed, static, color, atten, alive, orig, dir, n_rounds):
    """Run ``n_rounds`` more wavefront rounds on an already-shaded state,
    compacting the (monotonically shrinking) live set into a
    ``static.bounce_capacity``-lane buffer when it fits — SURVEY.md §7.2
    #4: masked-lane waste vs compaction.  When the live set overflows the
    capacity, lax.cond falls back to full-width rounds (correctness never
    depends on the bound).  cond, gather and scatter-add are all
    reverse-differentiable, so this also accelerates inverse rendering.

    Shared by trace_whitted (XLA round 0) and the fused Pallas primary
    kernel (which emits the same (color, atten, alive, orig, dir) carry)."""
    if n_rounds <= 0:
        return color
    n = int(np.prod(orig.shape[:-1]))
    cap = static.bounce_capacity
    if not cap or cap >= n or orig.ndim != 2:
        out = _run_rounds(
            packed, static, (jnp.zeros_like(color), atten, alive, orig, dir), n_rounds
        )
        return color + out[0]

    count = alive.sum()

    def full_path(color, atten, alive, orig, dir):
        out = _run_rounds(
            packed, static, (jnp.zeros_like(color), atten, alive, orig, dir), n_rounds
        )
        return color + out[0]

    def compact_path(color, atten, alive, orig, dir):
        sel = compact_indices(alive, n, cap)
        lane_live = jnp.arange(cap) < count  # slots past the live set are dead
        # ONE merged row gather instead of three: one index per lane
        g = jnp.concatenate([atten, orig, dir], axis=-1)[sel]  # junk slots clamp
        sub = (
            jnp.zeros((cap, 3), dtype=color.dtype),
            g[:, 0:3],
            lane_live,
            g[:, 3:6],
            g[:, 6:9],
        )
        out = _run_rounds(packed, static, sub, n_rounds)
        # junk slots (past the live count) scatter OUT OF RANGE and drop,
        # keeping the update indices sorted — sel is pos-ordered ascending
        # over the live slots, and sorted monotone scatters avoid XLA's
        # slow general-scatter lowering (the texel-VJP lesson)
        tgt = jnp.where(lane_live, sel, n)
        return color.at[tgt].add(out[0], mode="drop", indices_are_sorted=True)

    return jax.lax.cond(count <= cap, compact_path, full_path, color, atten, alive, orig, dir)


# --------------------------------------------------------------------------
# GI path trace (renderer.d:378-463), Lambert BRDF (shader.d:107-135)
# --------------------------------------------------------------------------


def trace_path(packed: ScenePacked, static: SceneStatic, orig, dir, key):
    """One path per input ray, unrolled to maxTraceDepth bounces.

    Quirks/extensions (see oracle/renderer.py and SceneStatic):
    * gi_multiplier_quirk (default True): the reference drops the path
      multiplier at every recursion (renderer.d:356), so bounces are not
      attenuated by throughput.
    * PointLight.solidAngle == 0 (light.d:72-75) zeroes the reference's
      explicit direct term; gi_point_light_direct=True replaces it with
      standard next-event estimation against point lights (extension).
    """
    for ns in static.nodes:
        if ns.shader_kind not in (LAMBERT, PHONG):
            raise NotImplementedError(
                "GI requires BRDF eval/spawnRay; only Lambert has them "
                "(extension shaders have none)"
            )
    # Phong's BRDF eval/spawnRay assert(0) in the reference
    # (shader.d:252-261) — a debug run aborts the moment a GI path SAMPLES
    # one, but a scene merely CONTAINING a Phong node renders fine until
    # then.  The device-renderable equivalent of per-path abort is the
    # engine's own bogus-BRDF marker (renderer.d:457: pdf < 0 returns
    # Color(1, 0, 0)): a path that hits a Phong node adds solid red —
    # UNSCALED, exactly like the reference's marker return, which
    # propagates to the top of the recursion without multiplier weighting
    # — and terminates (round-3 VERDICT item 6).
    has_phong_gi = any(ns.shader_kind == PHONG for ns in static.nodes)
    eps = S.shadow_eps(orig.dtype)
    acc = jnp.zeros_like(orig)
    mult = jnp.ones_like(orig)
    alive = jnp.ones(orig.shape[:-1], dtype=bool)

    def bounce(carry, _):
        key, acc, mult, alive, orig, dir = carry
        hit, win = G.scene_closest(packed, static, orig, dir)
        hitmask = alive & (win >= 0)
        winc = jnp.maximum(win, 0)
        if has_phong_gi:
            phong_hit = hitmask & (S.shader_kind_of(static, winc) == PHONG)
            red = jnp.asarray([1.0, 0.0, 0.0], dtype=orig.dtype)
            acc = acc + jnp.where(phong_hit[..., None], red, 0.0)
            hitmask = hitmask & ~phong_hit  # marker painted; path ends
        N = S.faceforward(dir, hit["normal"])
        diffuse = S.texture_color(packed, static, winc, hit["u"], hit["v"])

        mult_eff = jnp.ones_like(mult) if static.gi_multiplier_quirk else mult

        if static.has_env:
            from ..ops.env import sample_cubemap

            env = sample_cubemap(packed.env_cubemap, dir)
            acc = acc + jnp.where((alive & (win < 0))[..., None], mult_eff * env, 0.0)

        if static.gi_point_light_direct:
            shade_from = hit["p"] + N * eps
            for li in range(static.n_lights):
                lp = packed.light_pos[li]
                lc = packed.light_color[li] * packed.light_power[li]
                vis = G.test_visibility(packed, static, shade_from, jnp.broadcast_to(lp, shade_from.shape))
                to_light = lp - hit["p"]
                ld = _norm(to_light)
                brdf = diffuse * (1 / jnp.pi) * jnp.maximum(0.0, dot(ld, N))[..., None]
                term = lc * brdf / dot(to_light, to_light)[..., None]
                acc = acc + jnp.where((hitmask & vis)[..., None], mult_eff * term, 0.0)
        # else: reference direct term == 0 exactly (solidAngle = 0)

        # Lambert.spawnRay (shader.d:118-135): uniform-hemisphere sample
        key, k1, k2 = jax.random.split(key, 3)
        u = jax.random.uniform(k1, hit["u"].shape, dtype=orig.dtype)
        v = jax.random.uniform(k2, hit["u"].shape, dtype=orig.dtype)
        theta = 2 * jnp.pi * u
        phi = jnp.arccos(jnp.clip(2 * v - 1, -1.0, 1.0)) - jnp.pi / 2
        w = jnp.stack(
            [jnp.cos(theta) * jnp.cos(phi), jnp.sin(phi), jnp.sin(theta) * jnp.cos(phi)], axis=-1
        )
        w = jnp.where(dot(w, N)[..., None] < 0, -w, w)
        color_eval = diffuse * (1 / jnp.pi) * jnp.maximum(0.0, dot(w, N))[..., None]
        pdf = 1 / (2 * jnp.pi)
        mult = mult * color_eval / pdf
        orig = jnp.where(hitmask[..., None], hit["p"] + N * eps, orig)
        dir = jnp.where(hitmask[..., None], w, dir)
        return (key, acc, mult, hitmask, orig, dir), None

    carry = (key, acc, mult, alive, orig, dir)
    carry, _ = jax.lax.scan(bounce, carry, None, length=static.max_trace_depth + 1)
    return carry[1]


# --------------------------------------------------------------------------
# Per-pixel sampling dispatch (renderer.d:254-313)
# --------------------------------------------------------------------------


def render_samples(packed: ScenePacked, static: SceneStatic, frame, x, y, key, dx=1.0, dy=1.0,
                   stats=None, trace_fn=None, gi_trace_fn=None):
    """renderSample for a batch of (fractional) pixel coords -> [N, 3].

    ``trace_fn(packed, orig, dir)`` / ``gi_trace_fn(packed, orig, dir,
    key)`` override the Whitted / GI tracer while keeping THIS function's
    ray-gen and RNG streams byte-for-byte — the fused Pallas kernels plug
    in per mesh shard this way (parallel/mesh.py), so fused-vs-XLA
    sharded MC renders differ only by kernel fp."""
    cam = packed.camera
    W, H = float(static.width), float(static.height)

    def one_ray(xx, yy, stereo, k):
        return screen_rays(cam, frame, W, H, xx, yy, stereo, dof=static.dof, key=k)

    def trace_one(xx, yy, k, st=None):
        # dispatch priority matches renderSample (renderer.d:254-268):
        # DoF first, then GI (which ignores stereo — renderSampleGI traces
        # mono), then the default path where stereo applies.
        if static.gi_enabled and not static.dof:
            o, d = one_ray(xx, yy, 0.0, k)
            if gi_trace_fn is not None:
                return gi_trace_fn(packed, o, d, k)
            return trace_path(packed, static, o, d, k)
        whitted = trace_fn or (lambda p, o, d, st=None: trace_whitted(p, static, o, d, st))
        if static.stereo:
            ol, dl = one_ray(xx, yy, -1.0, k)
            orr, drr = one_ray(xx, yy, +1.0, k)
            left = whitted(packed, ol, dl, st)
            right = whitted(packed, orr, drr, st)
            return _combine_stereo(left, right)
        o, d = one_ray(xx, yy, 0.0, k)
        return whitted(packed, o, d, st)

    if static.dof or static.gi_enabled:
        # Monte-Carlo sample loop as a lax.scan with an accumulator carry:
        # one compiled sample body regardless of numSamples/pathsPerPixel,
        # and no [S, N, 3] intermediate.
        n_samples = static.dof_samples if static.dof else static.paths_per_pixel
        if stats is not None:
            # per-round counters can't escape a scan body; count camera rays
            # statically (MC modes are not the bench config)
            stats["camera"] = stats.get("camera", 0.0) + float(
                np.prod(x.shape) * n_samples * (2 if static.stereo else 1)
            )

        def body(carry, _):
            key, acc = carry
            key, kj, kj2, kr = jax.random.split(key, 4)
            jx = x + jax.random.uniform(kj, x.shape, dtype=x.dtype) * dx
            jy = y + jax.random.uniform(kj2, y.shape, dtype=y.dtype) * dy
            return (key, acc + trace_one(jx, jy, kr)), None

        (_, acc), _ = jax.lax.scan(
            body, (key, jnp.zeros(x.shape + (3,), dtype=x.dtype)), None, length=n_samples
        )
        return acc / n_samples

    return trace_one(x, y, key, stats)


def _combine_stereo(left, right):
    """Anaglyph combine (color.d:10-15)."""
    mid_l = left.mean(-1, keepdims=True)
    mid_r = right.mean(-1, keepdims=True)
    l = left * 0.25 + mid_l * 0.75
    r = right * 0.25 + mid_r * 0.75
    mask_l = jnp.asarray([1.0, 0.0, 0.0], dtype=left.dtype)
    mask_r = jnp.asarray([0.0, 1.0, 1.0], dtype=left.dtype)
    return l * mask_l + r * mask_r


# AA kernel offsets (renderer.d:235-242); sample 0 is the pass-2 sample.
AA_KERNEL = ((0.3, 0.3), (0.6, 0.0), (0.0, 0.6), (0.6, 0.6))


def aa_detect(img):
    """The reference's needs-AA detect pass (renderer.d:150-178): a pixel
    is flagged when any member of its clamped 5-point neighbourhood
    differs from the neighbourhood average by tooDifferent's default 0.1
    threshold (AAThreshold is never forwarded — renderer.d:172 quirk).
    Accumulation in f32 like the reference's Color.  [H, W, 3] -> [H, W]
    bool, stop_gradient'ed (the mask is a discrete decision)."""
    from ..utils.color import too_different

    f32 = img.astype(jnp.float32)
    neighs = [
        f32,
        jnp.concatenate([f32[:, :1], f32[:, :-1]], axis=1),  # x-1 (clamped)
        jnp.concatenate([f32[:, 1:], f32[:, -1:]], axis=1),  # x+1
        jnp.concatenate([f32[:1, :], f32[:-1, :]], axis=0),  # y-1
        jnp.concatenate([f32[1:, :], f32[-1:, :]], axis=0),  # y+1
    ]
    avg = sum(neighs) / jnp.float32(5.0)
    needs = jnp.zeros(img.shape[:2], bool)
    for nb in neighs:
        needs = needs | too_different(nb, avg)
    return jax.lax.stop_gradient(needs)


def _flat_pass(packed: ScenePacked, static: SceneStatic, frame, xf, yf, key,
               trace_fn=None, gi_trace_fn=None):
    """ONE render_samples pass over the flat pixel batch, honoring the
    chunk_pixels memory knob (per-slab key split, like render_frame's
    chunked body)."""
    n = xf.size
    c = static.chunk_pixels
    if not c or c >= n:
        return render_samples(packed, static, frame, xf, yf, key,
                              trace_fn=trace_fn, gi_trace_fn=gi_trace_fn)
    pad = (-n) % c
    dt = xf.dtype
    xs = jnp.concatenate([xf, jnp.zeros(pad, dtype=dt)]).reshape(-1, c)
    ys = jnp.concatenate([yf, jnp.zeros(pad, dtype=dt)]).reshape(-1, c)
    keys = jax.random.split(key, xs.shape[0])

    def body(args):
        cx, cy, ck = args
        return render_samples(packed, static, frame, cx, cy, ck,
                              trace_fn=trace_fn, gi_trace_fn=gi_trace_fn)

    out = jax.lax.map(body, (xs, ys, keys))
    return out.reshape(-1, 3)[:n]


def _render_pixels(packed: ScenePacked, static: SceneStatic, frame, xf, yf, key):
    """Base sample + AA taps for one flat pixel batch."""
    key, k0 = jax.random.split(key)
    img = render_samples(packed, static, frame, xf, yf, k0)

    if static.aa_enabled:
        # The 4 extra AA kernel taps as a lax.scan over the offsets: one
        # compiled sample body instead of 4 inlined pipeline copies.
        offsets = jnp.asarray(AA_KERNEL, dtype=xf.dtype)

        def aa_body(carry, off):
            key, acc = carry
            key, kk = jax.random.split(key)
            s = render_samples(packed, static, frame, xf + off[0], yf + off[1], kk)
            return (key, acc + s), None

        (_, acc), _ = jax.lax.scan(aa_body, (key, img), offsets)
        img = acc / 5.0
    return img


def render_frame(packed: ScenePacked, static: SceneStatic, key=None):
    """Full-frame render -> float [H, W, 3].  Jit with static_argnums=1 (see
    build_render_fn).

    With static.chunk_pixels set, the flat pixel batch is processed in
    lax.map slabs of that many rays: peak device memory is bounded by the slab
    size instead of the frame size (the reference's 48x48 bucket
    decomposition, renderer.d:194-213, reborn as a memory knob)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    dt = packed.node_matrix.dtype
    W, H = static.width, static.height

    mode = kernel_mode(static, dt)
    if mode != XLA:
        from ..ops import pallas_trace as PT

        interp = mode == INTERPRET
        if PT.supports(static):
            # fused Pallas round 0 (+ XLA bitmap gather / env / compacted
            # bounce rounds + AA loop); differentiable via the custom-VJP
            # kernels (ops/pallas_grad.py), so grad traces dispatch too
            return PT.build_flagship_renderer(static, W, H, interp)(packed, key)
        if PT.supports_gi(static):
            # GI: closest-hit + NEE light sums in-kernel, BRDF sampling in
            # XLA with the same jax.random stream as trace_path.  With
            # chunk_pixels set, the fused GI renderer runs lax.map slabs
            # through a slab-width kernel (same per-slab key splits as the
            # chunked XLA pipeline) — the memory knob and the fused path
            # compose (round-3 VERDICT item 5).
            return PT.build_gi_renderer(static, W, H, interp)(packed, key)
        note_xla_coverage("geometry, shader or ray-gen mode")

    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=dt), jnp.arange(W, dtype=dt), indexing="ij")
    xf = xs.reshape(-1)
    yf = ys.reshape(-1)
    frame = begin_frame(packed.camera, W / H, compensated=static.compensated_raygen)

    if static.aa_enabled and static.aa_adaptive:
        # adaptiveAA extension: pass-2 base sample, the reference's
        # needs-AA detect (aa_detect), then the 4 kernel taps applied only
        # where flagged.  UN-chunked, the key splits mirror _render_pixels
        # exactly, so flagged pixels take the very values the quirk path
        # would compute; chunked MC scenes draw a different (equally valid)
        # stream — the quirk path splits per slab inside each chunk, while
        # _flat_pass splits the tap key per slab.
        key, k0 = jax.random.split(key)
        base = _flat_pass(packed, static, frame, xf, yf, k0)
        mask = aa_detect(base.reshape(H, W, 3)).reshape(-1)
        offsets = jnp.asarray(AA_KERNEL, dtype=dt)

        def aa_body(carry, off):
            key, acc = carry
            key, kk = jax.random.split(key)
            s = _flat_pass(packed, static, frame, xf + off[0], yf + off[1], kk)
            return (key, acc + s), None

        (_, acc), _ = jax.lax.scan(aa_body, (key, base), offsets)
        img = jnp.where(mask[:, None], acc / 5.0, base)
        return img.reshape(H, W, 3)

    if not static.chunk_pixels or static.chunk_pixels >= W * H:
        img = _render_pixels(packed, static, frame, xf, yf, key)
        return img.reshape(H, W, 3)

    c = static.chunk_pixels
    n = W * H
    pad = (-n) % c
    xf = jnp.concatenate([xf, jnp.zeros(pad, dtype=dt)]).reshape(-1, c)
    yf = jnp.concatenate([yf, jnp.zeros(pad, dtype=dt)]).reshape(-1, c)
    keys = jax.random.split(key, xf.shape[0])

    def body(args):
        cx, cy, ck = args
        return _render_pixels(packed, static, frame, cx, cy, ck)

    img = jax.lax.map(body, (xf, yf, keys))
    return img.reshape(-1, 3)[:n].reshape(H, W, 3)


def build_render_fn(static: SceneStatic):
    """Compile a frame renderer for a fixed scene structure:
    ``fn(packed, key) -> [H, W, 3]``."""
    return jax.jit(partial(render_frame, static=static))


def render_scene_jax(scene, dtype=jnp.float32, key=None, fix=None):
    """Convenience: pack a host Scene and render one frame on device."""
    packed, static = pack_scene(scene, dtype=dtype)
    if fix is not None:
        static = fix(static)
    fn = jax.jit(lambda p, k: render_frame(p, static, k))
    return fn(packed, key if key is not None else jax.random.PRNGKey(0))
