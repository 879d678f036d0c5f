"""chess2rt_tpu — a differentiable Whitted-style ray-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the Chess2RT
reference renderer (a CPU ray tracer written in D):

- Scene model: plane / sphere / cube primitives, CSG boolean combinators,
  checker / procedural / bitmap textures, Lambert / Phong shading, point
  lights, pinhole camera with DoF + stereoscopic rendering.
- Scene files: the reference's SDLang and JSON schemas are parsed verbatim
  (reference: source/rt/scene_loader.d).
- Rendering: the reference's per-pixel recursive trace is re-designed as a
  fixed-depth wavefront pipeline over dense ray batches under one `jit`,
  differentiable end-to-end w.r.t. every continuous scene parameter.
- Scaling: pixel tiles are sharded over a `jax.sharding.Mesh`; scene params
  are replicated and gradients all-reduced with one `psum`.

Layout:
    utils/     vec3 math, color/sRGB, diagnostics (occupancy, NaN sweeps)
    imageio/   BMP codec (byte-compatible with the reference writer), EXR stubs
    scene/     SDLang + JSON scene loading (the compatibility surface)
    models/    typed scene object model + packed differentiable pytrees
    ops/       device kernels: ray-gen, intersect, CSG, textures, shading,
               environment cubemap, fused Pallas (Triton) primary pass
    render/    the wavefront render pipeline, buckets, async dispatch
    parallel/  mesh construction, sharded rendering, gradient all-reduce
    grad/      inverse-rendering optimisation + checkpoint/resume
    gui/       interactive session (camera drive, screenshots, inspection)
    chess/     the reference's vestigial chess data model
    oracle/    slow, trusted NumPy float64 reference implementation
    native.py  ctypes bridge to the C++ framebuffer codec (native/)
"""

__version__ = "0.1.0"

# Matmul precision policy: a float32 matmul may run in reduced precision
# by default (TF32 on the GPU's tensor cores keeps ~10 mantissa bits).  For
# a renderer whose camera basis and node transforms are 3x3 matmuls that
# moves rays by whole pixels at the horizon, so the package pins full f32
# precision.  The matmuls this framework runs are either tiny (3x3
# transforms, [N, n_nodes] one-hot gathers) or f32-accumulating gradient
# contractions, so full-precision passes cost ~nothing here.  Set as the
# package-wide default so every entry point (render, grad, sharded mesh,
# Pallas XLA glue) traces with it; chip_smoke.py's 96x54 oracle gate
# checks it on the card.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")
