"""Platform facts the CPU can check: which render path the dispatch
predicate picks per backend, that the fused kernel lowers for CUDA through
the Triton route, the compile-cache location, and that chip_smoke.py
refuses to run without a GPU.  ``gpu``-marked tests need the card and skip
here; chip_smoke.py covers the same ground on the GPU."""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chess2rt_tpu import dispatch
from chess2rt_tpu.models.packed import pack_scene
from chess2rt_tpu.scene import assets
from chess2rt_tpu.utils import cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    return pack_scene(assets.load_flagship(16, 8, aa=False), dtype=jnp.float32)


@pytest.mark.parametrize(
    "backend,use_pallas,interpret,dtype,expected",
    [
        ("gpu", True, False, jnp.float32, dispatch.COMPILED),
        ("gpu", True, True, jnp.float32, dispatch.COMPILED),  # never the interpreter
        ("gpu", False, False, jnp.float32, dispatch.XLA),
        ("gpu", True, False, jnp.float64, dispatch.XLA),  # the kernel is f32-only
        ("cpu", True, True, jnp.float32, dispatch.INTERPRET),
        ("cpu", True, False, jnp.float32, dispatch.XLA),
        ("cpu", False, True, jnp.float32, dispatch.XLA),
    ],
)
def test_kernel_mode(monkeypatch, tiny, backend, use_pallas, interpret, dtype, expected):
    _, static = tiny
    static = dataclasses.replace(static, use_pallas=use_pallas, interpret_pallas=interpret)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert dispatch.kernel_mode(static, dtype) == expected


def test_uncovered_scene_is_logged_once(caplog):
    import logging

    dispatch._noted.discard("test reason")
    with caplog.at_level(logging.INFO, logger="chess2rt_tpu.dispatch"):
        dispatch.note_xla_coverage("test reason")
        dispatch.note_xla_coverage("test reason")
    assert sum("test reason" in r.message for r in caplog.records) == 1


@pytest.mark.parametrize("form", ["screen", "rays", "lin", "hit_vis"])
def test_fused_kernel_lowers_for_cuda(tiny, form):
    """The Triton lowering runs on this host: a primitive it lacks fails
    here, not first on the card."""
    from chess2rt_tpu.ops.pallas_trace import build_round0_kernel

    packed, static = tiny
    w, h = static.width, static.height
    n = w * h
    if form == "screen":
        k = build_round0_kernel(static, w, h)
        f, args = (lambda p: k(p)), (packed,)
    elif form == "rays":
        k = build_round0_kernel(static, w, h, n_rays=n)
        o = jnp.zeros((n, 3), jnp.float32)
        d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
        f, args = (lambda p, o, d: k(p, o, d)), (packed, o, d)
    elif form == "lin":
        k = build_round0_kernel(static, w, h, n_rays=n, lin_input=True)
        f, args = (lambda p: k(p, jnp.float32(0.0))), (packed,)
    else:
        k = build_round0_kernel(static, w, h, n_rays=n, want_hit=True, want_vis=True)
        o = jnp.zeros((n, 3), jnp.float32)
        d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
        f, args = (lambda p, o, d: k(p, o, d)), (packed, o, d)
    text = jax.jit(f).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


def test_kernel_pads_lanes_and_params(tiny):
    """Ray batches that are not a block multiple pad with unit-z rays and
    come back sliced to their own length."""
    from chess2rt_tpu.ops import pallas_trace as PT

    packed, static = tiny
    n = PT.BLOCK + 5
    k = PT.build_round0_kernel(static, static.width, static.height, interpret=True, n_rays=n)
    o = jnp.tile(jnp.asarray([[0.0, 150.0, 0.0]], jnp.float32), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, -0.5, 0.866]], jnp.float32), (n, 1))
    out = jax.jit(lambda p: k(p, o, d))(packed)
    assert all(v.shape == (n,) for v in out.values())
    assert np.all(np.asarray(out["win"]) == np.asarray(out["win"])[0])


def test_compile_cache_dir_follows_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert cache.compile_cache_dir() == "/some/where"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert cache.compile_cache_dir() == str(ROOT / ".jax_cache")


def test_enable_compile_cache_sets_the_checkout_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
        assert cache.enable_compile_cache() == "/some/where"
        assert jax.config.jax_compilation_cache_dir == before  # JAX reads the variable
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert cache.enable_compile_cache() == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(ROOT / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: CHESS2RT_TEST_ON_GPU=1 pytest -m gpu)")


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu, tiny):
    from chess2rt_tpu.render.pipeline import render_frame

    packed, static = tiny
    key = jax.random.PRNGKey(0)
    st_k = dataclasses.replace(static, use_pallas=True)
    assert dispatch.kernel_mode(st_k) == dispatch.COMPILED
    a = jax.jit(lambda p: render_frame(p, st_k, key))(packed)
    b = jax.jit(lambda p: render_frame(p, dataclasses.replace(st_k, use_pallas=False), key))(packed)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3)
