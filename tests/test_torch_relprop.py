"""The port's rule library against the JAX rules, in float64 (rtol 1e-10).

Inputs are made from a seed with numpy and fed to both. The JAX rules are
per example; the port's take a leading batch dimension, so the JAX side is
looped over the batch where a rule sums per sample.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformer_explainability_tpu.ops import relprop as jrp
from transformer_explainability_torch.ops import relprop as trp

RTOL, ATOL = 1e-10, 1e-13


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_safe_divide_edge_cases(x64):
    a = np.array([1.0, 2.0, -3.0, 4.0, 5.0, 0.0])
    b = np.array([0.0, -1e-9, 2.0, -5e-10, 1e-300, 3.0])
    _close(trp.safe_divide(_t(a), _t(b)),
           jrp.safe_divide(jnp.asarray(a), jnp.asarray(b)))


def test_safe_divide_random(x64):
    rng = np.random.RandomState(0)
    a, b = rng.randn(7, 11), rng.randn(7, 11)
    b[0, :3] = 0.0
    _close(trp.safe_divide(_t(a), _t(b)),
           jrp.safe_divide(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("variant", ["ours", "lrp"])
@pytest.mark.parametrize("with_z", [False, True])
def test_add_relprop(x64, variant, with_z):
    rng = np.random.RandomState(1)
    B, n, D = 3, 9, 6
    a, b, R = rng.randn(B, n, D), rng.randn(B, n, D), rng.randn(B, n, D)
    Z = a + b if with_z else None
    ga, gb = trp.add_relprop(_t(a), _t(b), _t(R), variant,
                             Z=None if Z is None else _t(Z))
    for i in range(B):
        wa, wb = jrp.add_relprop(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                 jnp.asarray(R[i]), variant,
                                 Z=None if Z is None else jnp.asarray(Z[i]))
        _close(ga[i], wa)
        _close(gb[i], wb)


def test_clone_relprop(x64):
    rng = np.random.RandomState(2)
    x, r1, r2 = rng.randn(2, 5, 4), rng.randn(2, 5, 4), rng.randn(2, 5, 4)
    x[0, 0, 0] = 0.0
    _close(trp.clone_relprop(_t(x), [_t(r1), _t(r2)]),
           jrp.clone_relprop(jnp.asarray(x), [jnp.asarray(r1),
                                              jnp.asarray(r2)]))


def test_index_select_relprop(x64):
    rng = np.random.RandomState(3)
    B, n, D = 3, 7, 5
    x, R = rng.randn(B, n, D), rng.randn(B, 1, D)
    got = trp.index_select_relprop(_t(x), 1, 0, _t(R))
    for i in range(B):
        want = jrp.index_select_relprop(jnp.asarray(x[i]), 0, jnp.array(0),
                                        jnp.asarray(R[i]))
        _close(got[i], want)


def test_einsum_qk_relprop(x64):
    rng = np.random.RandomState(4)
    q, k, R = rng.randn(2, 3, 8, 4), rng.randn(2, 3, 8, 4), rng.randn(2, 3, 8, 8)
    gq, gk = trp.einsum_qk_relprop(_t(q), _t(k), _t(R))
    for i in range(2):
        wq, wk = jrp.einsum_qk_relprop(jnp.asarray(q[i]), jnp.asarray(k[i]),
                                       jnp.asarray(R[i]))
        _close(gq[i], wq)
        _close(gk[i], wk)


def test_einsum_av_relprop(x64):
    rng = np.random.RandomState(5)
    a, v, R = rng.randn(2, 3, 8, 8), rng.randn(2, 3, 8, 4), rng.randn(2, 3, 8, 4)
    ga, gv = trp.einsum_av_relprop(_t(a), _t(v), _t(R))
    for i in range(2):
        wa, wv = jrp.einsum_av_relprop(jnp.asarray(a[i]), jnp.asarray(v[i]),
                                       jnp.asarray(R[i]))
        _close(ga[i], wa)
        _close(gv[i], wv)


@pytest.mark.parametrize("variant", ["ours", "lrp"])
@pytest.mark.parametrize("alpha", [1.0, 2.0])
@pytest.mark.parametrize("use_y_pre", [False, True])
def test_linear_alphabeta(x64, variant, alpha, use_y_pre):
    # 32 inputs per output: with a handful, x@w ≈ |x|@|w| (all terms of one
    # sign) is likely, and the α≠1 inhibitor denominator (x@w − |x|@|w|)/2
    # then cancels to a few digits in any summation order
    rng = np.random.RandomState(6)
    x, w, R = rng.randn(2, 7, 32), rng.randn(32, 5), rng.randn(2, 7, 5)
    y_pre = x @ w if use_y_pre else None
    got = trp.linear_alphabeta(_t(x), _t(w), _t(R), alpha, variant,
                               y_pre=None if y_pre is None else _t(y_pre))
    for i in range(2):
        want = jrp.linear_alphabeta(
            jnp.asarray(x[i]), jnp.asarray(w), jnp.asarray(R[i]), alpha,
            variant, y_pre=None if y_pre is None else jnp.asarray(y_pre[i]))
        _close(got[i], want)


def test_linear_alphabeta_vector_input(x64):
    """The pooled-CLS head: one (D,) row per sample."""
    rng = np.random.RandomState(7)
    x, w, R = rng.randn(3, 6), rng.randn(6, 4), rng.randn(3, 4)
    got = trp.linear_alphabeta(_t(x), _t(w), _t(R))
    for i in range(3):
        _close(got[i], jrp.linear_alphabeta(jnp.asarray(x[i]), jnp.asarray(w),
                                            jnp.asarray(R[i])))


def test_patchify(x64):
    rng = np.random.RandomState(8)
    img = rng.randn(2, 3, 32, 48)
    got = trp.patchify(_t(img), 16)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(got[i]), np.asarray(jrp.patchify(jnp.asarray(img[i]),
                                                        16)))


@pytest.mark.parametrize("start_layer", [0, 2])
@pytest.mark.parametrize("row_normalize", [False, True])
def test_compute_rollout(x64, start_layer, row_normalize):
    rng = np.random.RandomState(9)
    cams = np.abs(rng.randn(2, 4, 9, 9)) * 0.1
    got = trp.compute_rollout(_t(cams), start_layer, row_normalize)
    for i in range(2):
        _close(got[i], jrp.compute_rollout(jnp.asarray(cams[i]), start_layer,
                                           row_normalize))
