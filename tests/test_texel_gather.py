"""ops/shade.quad_gather_flat: the plain row gather forward (out-of-range
keys clamp, like the compaction gathers rely on) and its texel-grad
scatter-add VJP, which must equal the native gather transpose and a
finite difference, with keys heavily duplicated or all distinct."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chess2rt_tpu.ops.shade import quad_gather_flat

KEYS = ["duplicated", "distinct"]


def _table_and_keys(keys, rows=300, cols=12, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    tab = jnp.asarray(rng.standard_normal((rows, cols)).astype(np.float32))
    if keys == "duplicated":  # as when many rays land on one texel
        key = rng.integers(0, rows // 10, n)
    else:
        key = rng.permutation(rows)
    return tab, jnp.asarray(key.astype(np.int32))


@pytest.mark.parametrize("keys", KEYS)
def test_forward_is_plain_gather(keys):
    tab, key = _table_and_keys(keys)
    out = jax.jit(quad_gather_flat)(tab, key)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(tab[key]))


def test_out_of_range_keys_clamp():
    tab = jnp.arange(12.0, dtype=jnp.float32).reshape(4, 3)
    key = jnp.asarray([7, 2], jnp.int32)
    out = jax.jit(quad_gather_flat)(tab, key)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(tab[jnp.asarray([3, 2])]))


@pytest.mark.parametrize("keys", KEYS)
def test_vjp_matches_native_gather(keys):
    tab, key = _table_and_keys(keys, seed=1)
    ct = jnp.asarray(np.random.default_rng(2).standard_normal((key.shape[0], 12)), jnp.float32)

    def via(gather):
        return jax.jit(jax.grad(lambda t: (gather(t) * ct).sum()))(tab)

    got = via(lambda t: quad_gather_flat(t, key))
    want = via(lambda t: t[key])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("keys", KEYS)
def test_vjp_matches_finite_difference(keys):
    """The loss is quadratic in the table, so a central difference along a
    random direction is exact up to rounding."""
    tab, key = _table_and_keys(keys, rows=64, n=512, seed=3)
    w = jnp.asarray(np.random.default_rng(4).standard_normal((key.shape[0], 12)), jnp.float32)

    def loss(t):
        return (quad_gather_flat(t, key) ** 2 * w).sum()

    g = np.asarray(jax.grad(loss)(tab), np.float64)
    d = np.random.default_rng(5).standard_normal(tab.shape)
    eps = 1e-2
    dj = jnp.asarray(d, jnp.float32)
    fd = (float(loss(tab + eps * dj)) - float(loss(tab - eps * dj))) / (2 * eps)
    np.testing.assert_allclose((g * d).sum(), fd, rtol=2e-3)
