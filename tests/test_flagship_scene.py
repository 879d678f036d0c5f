"""The in-repo flagship scene (scenes/flagship.sdl) and its generated
textures: parse, deterministic texture bytes, oracle agreement of the f32
XLA frame, and the fused Triton-route kernel in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from chess2rt_tpu.models import types as T
from chess2rt_tpu.models.packed import pack_scene
from chess2rt_tpu.scene import assets
from chess2rt_tpu.scene.loader import parse_scene_from_file


def test_flagship_parses_with_expected_structure():
    sc = parse_scene_from_file(assets.flagship_scene_path())
    assert (sc.settings.frameWidth, sc.settings.frameHeight) == (1920, 1080)
    assert sc.settings.maxTraceDepth == 5 and sc.settings.AAEnabled
    named = sc.named["geometries"]
    assert isinstance(named["diff"], T.CsgDiff)
    assert isinstance(named["diff"].left, T.Cube) and isinstance(named["diff"].right, T.Sphere)
    assert named["mirror_ball"].center == (0.0, 60.0, 360.0) and named["mirror_ball"].R == 55.0
    shaders = [type(n.shader) for n in sc.nodes]
    assert shaders.count(T.Phong) == 4 and shaders.count(T.Reflection) == 1
    np.testing.assert_allclose(sc.named["nodes"]["S1"].transform.offset, [100, 15, 256])
    globe = sc.named["textures"]["world"]
    floor = sc.named["textures"]["bmp"]
    assert globe.data.shape == (1024, 2048, 3) and floor.data.shape == (1024, 1024, 3)
    assert floor.scaling == 0.005


def test_textures_are_byte_identical_across_generations(tmp_path, monkeypatch):
    assets.ensure_flagship_textures()
    first = {n: (assets.TEXTURE_DIR / n).read_bytes() for n in ("world.bmp", "floor.bmp")}
    monkeypatch.setattr(assets, "TEXTURE_DIR", tmp_path)
    assets.ensure_flagship_textures()
    for name, data in first.items():
        assert (tmp_path / name).read_bytes() == data, name
    # idempotent: an existing file is left alone
    stamp = (tmp_path / "world.bmp").stat().st_mtime_ns
    assets.ensure_flagship_textures()
    assert (tmp_path / "world.bmp").stat().st_mtime_ns == stamp


def test_gi_twin_has_no_gi_less_shaders():
    sc = assets.load_flagship_gi(32, 18, paths=4)
    assert sc.settings.GIEnabled and not sc.settings.AAEnabled
    assert all(isinstance(n.shader, T.Lambert) for n in sc.nodes)
    assert len(sc.nodes) == 6


def test_f32_xla_frame_matches_oracle():
    """One sample per pixel: at 32x18 the AA taps of the horizon row land
    where the floor's f32 texture coordinates lose whole texels against
    the f64 oracle (chip_smoke.py gates the AA5 frame at 96x54)."""
    from chess2rt_tpu.oracle.renderer import render_scene
    from chess2rt_tpu.render.pipeline import render_frame
    from chess2rt_tpu.utils.color import srgb_u8

    sc = assets.load_flagship(32, 18, aa=False)
    ref = srgb_u8(render_scene(sc)).astype(int)
    packed, static = pack_scene(sc, dtype=jnp.float32)
    dev = jax.jit(lambda p: render_frame(p, static, jax.random.PRNGKey(0)))(packed)
    within1 = (np.abs(srgb_u8(np.asarray(dev)).astype(int) - ref) <= 1).mean()
    assert within1 >= 0.99, within1


def test_triton_kernel_interpret_matches_xla():
    """The fused kernel on the Triton route, run by the Pallas interpreter,
    against the XLA wavefront: CSG, transforms, deferred bitmaps, Phong and
    the mirror bounce rounds."""
    from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer, supports
    from chess2rt_tpu.render.pipeline import render_frame

    packed, static = pack_scene(assets.load_flagship(16, 8, aa=False), dtype=jnp.float32)
    assert supports(static)
    out = jax.jit(lambda p: build_flagship_renderer(static, 16, 8, interpret=True)(p))(packed)
    ref = jax.jit(lambda p: render_frame(p, static, jax.random.PRNGKey(0)))(packed)
    d = np.abs(np.asarray(out) - np.asarray(ref)).max(-1)
    assert (d > 2e-3).sum() <= 1 and np.median(d) < 2e-4, (d.max(), (d > 2e-3).sum())


def test_render_frame_dispatches_interpret_kernel_on_cpu():
    """use_pallas + interpret_pallas routes render_frame through the
    interpreted kernel on the CPU; the frame matches the XLA one."""
    from chess2rt_tpu.render.pipeline import render_frame

    packed, static = pack_scene(assets.load_flagship(16, 8, aa=False), dtype=jnp.float32)
    st_k = dataclasses.replace(static, use_pallas=True, interpret_pallas=True, max_trace_depth=1)
    st_x = dataclasses.replace(st_k, use_pallas=False)
    key = jax.random.PRNGKey(0)
    a = jax.jit(lambda p: render_frame(p, st_k, key))(packed)
    b = jax.jit(lambda p: render_frame(p, st_x, key))(packed)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3)
