"""Distribution: pixel-tile data parallelism over a jax.sharding.Mesh.

The reference's only parallelism is a thread pool over 48x48 image buckets
(renderer.d:133-136, SURVEY.md §2.7).  The device equivalent is:

* a 1-D device mesh over all chips (across hosts when launched under
  ``jax.distributed.initialize``) with axis name ``"px"``;
* the flattened pixel/ray batch **sharded** over that axis, the ScenePacked
  parameter pytree **replicated**;
* the forward render is embarrassingly parallel — zero collectives; the
  framebuffer shards are gathered only at the host boundary;
* the backward pass (inverse rendering) combines per-shard parameter
  gradients with a single ``pmean`` — XLA lowers it to an all-reduce
  (NCCL over NVLink between the cards of one host), overlapped with
  backward compute by the latency-hiding scheduler (SURVEY.md §5.8).

Everything is expressed with ``shard_map`` so the collectives are explicit
and the per-shard code is exactly the single-chip pipeline.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dispatch import INTERPRET, XLA, kernel_mode, note_xla_coverage
from ..models.packed import ScenePacked, SceneStatic
from ..render.pipeline import AA_KERNEL, _flat_pass, begin_frame

AXIS = "px"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices; axis "px" shards pixels."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (AXIS,))


def make_mesh_2d(devices=None, hosts=None) -> Mesh:
    """2-D (hosts x chips) mesh (SURVEY.md §5.8).  Pixels shard over BOTH
    axes (the flat ray batch is tiled over the full device grid); the
    gradient all-reduce then decomposes into a process-local chip-axis
    reduce and a cross-process host-axis reduce.  ``hosts`` defaults to
    jax.process_count() when multi-process, else the largest power-of-two
    split."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if hosts is None:
        hosts = jax.process_count()
        if hosts <= 1 or n % hosts:
            hosts = 1
            while n % (hosts * 2) == 0 and (hosts * 2) * (hosts * 2) <= n:
                hosts *= 2
    assert n % hosts == 0, (n, hosts)
    return Mesh(devices.reshape(hosts, n // hosts), ("host", "chip"))


def _axes(mesh: Mesh):
    return tuple(mesh.axis_names)


def _linear_index(axes):
    """Global linear shard index over (possibly several) mesh axes."""
    idx = jax.lax.axis_index(axes[0])
    for a in axes[1:]:
        idx = idx * jax.lax.psum(1, a) + jax.lax.axis_index(a)
    return idx


def _pixel_coords(static: SceneStatic, n_shards: int, dtype):
    """Flat pixel coords padded to a multiple of the shard count.  Padding
    pixels re-render pixel (0, 0) and are dropped on reshape."""
    W, H = static.width, static.height
    n = W * H
    pad = (-n) % n_shards
    ys, xs = np.mgrid[0:H, 0:W]
    xf = np.concatenate([xs.reshape(-1), np.zeros(pad, dtype=np.int64)])
    yf = np.concatenate([ys.reshape(-1), np.zeros(pad, dtype=np.int64)])
    return xf.astype(dtype), yf.astype(dtype), n


def _frame_from_samples(flat, static: SceneStatic):
    n = static.width * static.height
    return flat[:n].reshape(static.height, static.width, 3)


def _sample_pixels(packed: ScenePacked, static: SceneStatic, xf, yf, key, mask=None, base=None,
                   trace_fn=None, gi_trace_fn=None):
    """Per-shard sampling incl. the AA supersample — identical math to the
    single-chip render_frame (render/pipeline.py).

    ``mask`` (adaptiveAA extension): the per-shard slice of the FULL-frame
    needs-AA mask — it cannot be computed here because the detect pass
    reads cross-shard pixel neighbourhoods; callers compute it on the
    global base frame (aa_detect halo comms are inserted by the SPMD
    partitioner) and pass the shard in.  The mask is stop-gradient, so a
    mask from a separate forward pass is exactly the adaptive semantics.

    ``base``: the shard's already-rendered pass-2 sample, reused by the
    forward adaptive path (grad callers must leave it None so unflagged
    pixels keep their gradient path through the in-trace base render).

    chunk_pixels is honored PER SHARD via _flat_pass (lax.map slabs —
    renderer.d:194-213's bounded buckets under the mesh: a distributed 8K
    render keeps per-shard device memory bounded by the slab)."""
    frame = begin_frame(packed.camera, static.width / static.height)
    img = base if base is not None else _flat_pass(
        packed, static, frame, xf, yf, key, trace_fn=trace_fn, gi_trace_fn=gi_trace_fn
    )
    if static.aa_enabled:
        offsets = jnp.asarray(AA_KERNEL, dtype=xf.dtype)

        def aa_body(carry, off):
            i, acc = carry
            kk = jax.random.fold_in(key, i)
            s = _flat_pass(packed, static, frame, xf + off[0], yf + off[1], kk,
                           trace_fn=trace_fn, gi_trace_fn=gi_trace_fn)
            return (i + 1, acc + s), None

        (_, acc), _ = jax.lax.scan(aa_body, (jnp.int32(1), img), offsets)
        if mask is not None:
            img = jnp.where(mask[:, None], acc / 5.0, img)
        else:
            img = acc / 5.0
    return img


def _fused_shard_setup(static: SceneStatic, mesh: Mesh):
    """Per-shard FUSED renderer for this mesh, or None when the scene /
    backend wants the XLA pipeline (MC modes, GI, unsupported geometry,
    CPU without interpret mode).

    Returns (rows, C, n_pad): ``rows`` renders one contiguous C-lane pixel
    slice through the Pallas lin-input kernel (ops/pallas_trace.
    build_rows_renderer); the frame pads to n_pad = n_shards * C with C a
    BOUNCE_BLOCK multiple so block-granular bounce compaction stays live
    per shard, so the mesh runs the same fused path as one device."""
    mode = kernel_mode(static)
    if mode == XLA or static.gi_enabled or static.dof or static.stereo:
        return None
    from ..ops import pallas_trace as PT

    if not PT.supports(static):
        note_xla_coverage("geometry, shader or ray-gen mode")
        return None
    n_shards = mesh.devices.size
    n = static.width * static.height
    n_pad = n + (-n) % (n_shards * PT.BOUNCE_BLOCK)
    C = n_pad // n_shards
    rows = PT.build_rows_renderer(
        static, static.width, static.height, mode == INTERPRET, C
    )
    return rows, C, n_pad


def _fused_trace_fns(static: SceneStatic):
    """Kernel-backed tracer overrides for the XLA per-shard sampler — the
    MC (DoF/stereo) and GI modes under the mesh (round 4): render_samples
    keeps its ray-gen and RNG streams byte-for-byte and only the tracer
    swaps to the fused kernel, so fused-vs-XLA sharded MC frames differ by
    kernel fp only.  Kernels are built lazily per ray-batch width (shard
    width vs chunk-slab width) and cached.  Returns (trace_fn,
    gi_trace_fn), each possibly None."""
    mode = kernel_mode(static)
    if mode == XLA:
        return None, None
    from ..ops import pallas_trace as PT

    W, H, interp = static.width, static.height, mode == INTERPRET
    trace_fn = gi_trace_fn = None
    if not static.gi_enabled and PT.supports(static):
        from ..ops.pallas_grad import build_trace_round0

        cache = {}

        def trace_fn(packed, o3, d3, st=None):
            if o3.dtype != jnp.float32:  # f64 oracle-parity runs stay XLA
                from ..render.pipeline import trace_whitted

                return trace_whitted(packed, static, o3, d3, st)
            n = int(o3.shape[0])
            if n not in cache:
                kern = build_trace_round0(static, W, H, interp, n_rays=n)
                fin = PT.build_bounce_finisher(static, W, H, interp, n, is_slab=True)
                cache[n] = (kern, fin)
            kern, fin = cache[n]
            o = kern(packed, o3, d3)
            color, cont, atten, ro, rd = PT.combine_outputs(
                packed, static, o, d3 if static.has_env else None
            )
            return fin(packed, color, cont, atten, ro, rd)

    if static.gi_enabled and not static.dof and PT.supports_gi(static):
        cache_gi = {}

        def gi_trace_fn(packed, o3, d3, key):
            if o3.dtype != jnp.float32:
                from ..render.pipeline import trace_path

                return trace_path(packed, static, o3, d3, key)
            n = int(o3.shape[0])
            if n not in cache_gi:
                cache_gi[n] = PT.build_gi_tracer(static, W, H, interp, n)
            return cache_gi[n](packed, o3, d3, jnp.stack([key]))

    return trace_fn, gi_trace_fn


def make_sharded_render_fn(static: SceneStatic, mesh: Mesh):
    """Compile ``fn(packed, key) -> [H, W, 3]`` with pixels sharded over the
    mesh (1-D "px" or 2-D (host, chip) — the flat ray batch tiles over ALL
    mesh axes).  Per-shard work = the plain single-chip pipeline: the fused
    Pallas flagship renderer when the scene supports it (f32 deterministic
    Whitted), the XLA wavefront otherwise (MC/GI modes, f64 parity runs)."""
    axes = _axes(mesh)
    # kernel-backed tracer overrides for the MC/GI modes (None when the
    # XLA tracer should stay)
    tf, gtf = _fused_trace_fns(static)
    # check_vma=False on every sampling shard_map: (a) pallas_call outputs
    # carry no varying-mesh-axes info, and (b) the MC sample scans
    # initialize zero carries that the vma checker types as replicated
    # while the body output is varying (a pcast would be needed per scan
    # init).  Replication correctness is pinned by the bit-identical /
    # stream-identical sharded-vs-single-chip tests instead.
    vma_kw = {"check_vma": False}

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axes), P(axes), P()),
        out_specs=P(axes),
        **vma_kw,
    )
    def shard_render(packed: ScenePacked, xf, yf, key):
        # decorrelate stochastic sampling (DoF/GI jitter) across shards
        key = jax.random.fold_in(key, _linear_index(axes))
        return _sample_pixels(packed, static, xf, yf, key, trace_fn=tf, gi_trace_fn=gtf)

    adaptive = static.aa_enabled and static.aa_adaptive
    if adaptive:
        import dataclasses

        static_base = dataclasses.replace(static, aa_enabled=False)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(axes), P(axes), P()),
            out_specs=P(axes),
            **vma_kw,
        )
        def shard_base(packed: ScenePacked, xf, yf, key):
            key = jax.random.fold_in(key, _linear_index(axes))
            return _sample_pixels(packed, static_base, xf, yf, key,
                                  trace_fn=tf, gi_trace_fn=gtf)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(axes), P(axes), P(axes), P(axes, None), P()),
            out_specs=P(axes),
            **vma_kw,
        )
        def shard_taps(packed: ScenePacked, xf, yf, mask, base, key):
            key = jax.random.fold_in(key, _linear_index(axes))
            return _sample_pixels(packed, static, xf, yf, key, mask=mask, base=base,
                                  trace_fn=tf, gi_trace_fn=gtf)

    n_shards = mesh.devices.size

    fused = _fused_shard_setup(static, mesh)
    if fused is not None:
        rows, C, _ = fused

        # check_vma=False on every fused shard_map: pallas_call outputs
        # carry no varying-mesh-axes info, so the replication checker
        # can't type them (same rationale as shard_step below)
        @partial(jax.shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(axes),
                 check_vma=False)
        def shard_fused(packed: ScenePacked):
            return rows(packed, _linear_index(axes) * C)

        if adaptive:

            @partial(jax.shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(axes),
                     check_vma=False)
            def shard_fused_base(packed: ScenePacked):
                lb = jnp.asarray(_linear_index(axes) * C, jnp.float32)
                return rows.tap(packed, lb, jnp.zeros(2, jnp.float32))

            @partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(), P(axes), P(axes, None)),
                out_specs=P(axes),
                check_vma=False,
            )
            def shard_fused_taps(packed: ScenePacked, mask, base):
                return rows(packed, _linear_index(axes) * C, mask=mask, base=base)

    @jax.jit
    def fn(packed: ScenePacked, key):
        dt = packed.node_matrix.dtype
        if fused is not None and dt == jnp.float32:
            # deterministic fused path: the kernel ray-gens from each
            # shard's lin base, so no pixel-coord arrays ship at all
            if adaptive:
                base = shard_fused_base(packed)
                mask = _mask_from_base(base, static)
                flat = shard_fused_taps(packed, mask, base)
            else:
                flat = shard_fused(packed)
            return _frame_from_samples(flat, static)
        xf, yf, _ = _pixel_coords(static, n_shards, np.float64)
        xs = jax.device_put(jnp.asarray(xf, dtype=dt), NamedSharding(mesh, P(axes)))
        ys = jax.device_put(jnp.asarray(yf, dtype=dt), NamedSharding(mesh, P(axes)))
        if adaptive:
            # adaptiveAA: sharded base pass, the needs-AA detect on the
            # GLOBAL frame (the partitioner inserts the halo exchange for
            # the neighbour reads), then sharded taps with mask select
            base = shard_base(packed, xs, ys, key)
            mask = _mask_from_base(base, static)
            flat = shard_taps(packed, xs, ys, mask, base, key)
        else:
            flat = shard_render(packed, xs, ys, key)
        return _frame_from_samples(flat, static)

    return fn


def _mask_from_base(base_flat, static: SceneStatic):
    """Padded flat needs-AA mask from the padded flat sharded base pass
    (adaptiveAA): detect runs on the global [H, W, 3] frame."""
    from ..render.pipeline import aa_detect

    n = static.width * static.height
    pad = base_flat.shape[0] - n
    mask = aa_detect(base_flat[:n].reshape(static.height, static.width, 3)).reshape(-1)
    return jnp.concatenate([mask, jnp.zeros(pad, dtype=bool)])


def render_frame_distributed(packed: ScenePacked, static: SceneStatic, mesh=None, key=None):
    """One-shot distributed render."""
    mesh = mesh if mesh is not None else make_mesh()
    fn = make_sharded_render_fn(static, mesh)
    return fn(packed, key if key is not None else jax.random.PRNGKey(0))


def make_sharded_value_and_grad(static: SceneStatic, mesh: Mesh):
    """Compile ``fn(packed, target_hw3, key) -> (loss, grads)`` for inverse
    rendering: pixel-sharded forward, per-shard backward, and a single pmean
    all-reduce of the parameter gradients (SURVEY.md §5.8).

    loss = mean squared error against the target frame."""
    n_shards = mesh.devices.size
    axes = _axes(mesh)

    adaptive = static.aa_enabled and static.aa_adaptive

    fused = _fused_shard_setup(static, mesh)
    if fused is not None:
        rows, C, fused_n_pad = fused

        def shard_loss_fused(packed, target, weight, mask, lin_base):
            # mask (adaptive only) is stop-gradient from a separate base
            # pass; rows() re-renders the base IN-trace so unflagged
            # pixels keep their gradient path (same contract as the XLA
            # _sample_pixels path)
            img = rows(packed, lin_base, mask=mask if adaptive else None)
            return ((img - target) ** 2 * weight[..., None]).sum() / (
                static.width * static.height * 3
            )

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(axes, None), P(axes), P(axes)),
            out_specs=(P(), P()),
            # same check_vma rationale as shard_step below: the custom-VJP
            # kernels are opaque to the replication checker
            check_vma=False,
        )
        def shard_step_fused(packed, target, weight, mask):
            lb = _linear_index(axes) * C
            loss, grads = jax.value_and_grad(shard_loss_fused)(
                packed, target, weight, mask, lb
            )
            grads = jax.tree.map(lambda g: jax.lax.psum(g, axes), grads)
            return jax.lax.psum(loss, axes), grads

        if adaptive:

            @partial(jax.shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(axes),
                     check_vma=False)
            def shard_fused_base(packed: ScenePacked):
                lb = jnp.asarray(_linear_index(axes) * C, jnp.float32)
                return rows.tap(packed, lb, jnp.zeros(2, jnp.float32))

    tf, gtf = _fused_trace_fns(static)

    def shard_loss(packed, xf, yf, target, weight, mask, key):
        # adaptiveAA: the (stop-gradient) mask comes from a separate
        # forward base pass; base renders IN-trace so unflagged pixels
        # keep their gradient path
        img = _sample_pixels(packed, static, xf, yf, key, mask=mask if adaptive else None,
                             trace_fn=tf, gi_trace_fn=gtf)
        # weight zeroes the padding lanes so they don't pollute the loss
        return ((img - target) ** 2 * weight[..., None]).sum() / (static.width * static.height * 3)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axes), P(axes), P(axes, None), P(axes), P(axes), P()),
        out_specs=(P(), P()),
        # the texel-gradient custom VJP (ops/shade._quad_gather) is opaque
        # to the varying-mesh-axes inference, which then can't prove the
        # grads replicated; the explicit psums below make it true by
        # construction (asserted against single-device grads in
        # tests/test_parallel.py)
        check_vma=False,
    )
    def shard_step(packed, xf, yf, target, weight, mask, key):
        key = jax.random.fold_in(key, _linear_index(axes))
        loss, grads = jax.value_and_grad(shard_loss)(packed, xf, yf, target, weight, mask, key)
        # Per-shard gradients are combined by ONE explicit psum per leaf —
        # the all-reduce of SURVEY.md §5.8 (on a 2-D (host, chip) mesh XLA
        # decomposes it into a process-local and a cross-process stage),
        # overlapped with backward compute by the latency-hiding scheduler.
        # (With check_vma=False — needed because the texel-gradient
        # custom VJP is opaque to the replication checker — shard_map does
        # NOT insert the broadcast-transpose psum automatically; grads
        # correctness vs single-device is pinned by tests/test_parallel.py.)
        grads = jax.tree.map(lambda g: jax.lax.psum(g, axes), grads)
        return jax.lax.psum(loss, axes), grads

    if adaptive:
        import dataclasses

        static_base = dataclasses.replace(static, aa_enabled=False)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(axes), P(axes), P()),
            out_specs=P(axes),
            check_vma=False,  # see make_sharded_render_fn's vma_kw note
        )
        def shard_base(packed: ScenePacked, xf, yf, key):
            # same per-shard key fold as shard_step, so the mask comes from
            # the very base sample the loss recomputes in-trace
            key = jax.random.fold_in(key, _linear_index(axes))
            return _sample_pixels(packed, static_base, xf, yf, key,
                                  trace_fn=tf, gi_trace_fn=gtf)

    @jax.jit
    def fn(packed: ScenePacked, target, key):
        dt = packed.node_matrix.dtype
        if fused is not None and dt == jnp.float32:
            n = static.width * static.height
            pad = fused_n_pad - n
            tflat = jnp.concatenate(
                [target.reshape(-1, 3).astype(dt), jnp.zeros((pad, 3), dtype=dt)]
            )
            weight = jnp.concatenate([jnp.ones(n, dtype=dt), jnp.zeros(pad, dtype=dt)])
            tflat = jax.device_put(tflat, NamedSharding(mesh, P(axes, None)))
            weight = jax.device_put(weight, NamedSharding(mesh, P(axes)))
            if adaptive:
                mask = jax.lax.stop_gradient(
                    _mask_from_base(shard_fused_base(packed), static)
                )
            else:
                mask = jnp.zeros(fused_n_pad, dtype=bool)
            return shard_step_fused(packed, tflat, weight, mask)
        xf, yf, n = _pixel_coords(static, n_shards, np.float64)
        pad = xf.shape[0] - n
        sh = NamedSharding(mesh, P(axes))
        xs = jax.device_put(jnp.asarray(xf, dtype=dt), sh)
        ys = jax.device_put(jnp.asarray(yf, dtype=dt), sh)
        tflat = target.reshape(-1, 3).astype(dt)
        tflat = jnp.concatenate([tflat, jnp.zeros((pad, 3), dtype=dt)])
        weight = jnp.concatenate([jnp.ones(n, dtype=dt), jnp.zeros(pad, dtype=dt)])
        tflat = jax.device_put(tflat, NamedSharding(mesh, P(axes, None)))
        weight = jax.device_put(weight, sh)
        if adaptive:
            mask = _mask_from_base(shard_base(packed, xs, ys, key), static)
            mask = jax.lax.stop_gradient(mask)
        else:
            mask = jnp.zeros(xf.shape[0], dtype=bool)
        return shard_step(packed, xs, ys, tflat, weight, mask, key)

    return fn
