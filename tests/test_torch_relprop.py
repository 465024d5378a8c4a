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


def test_unpatchify(x64):
    rng = np.random.RandomState(10)
    patches = rng.randn(2, 6, 3 * 16 * 16)
    got = trp.unpatchify(_t(patches), 16, 3, 32, 48)
    for i in range(2):
        np.testing.assert_array_equal(
            np.asarray(got[i]), np.asarray(jrp.unpatchify(
                jnp.asarray(patches[i]), 16, 3, 32, 48)))
    torch.testing.assert_close(trp.patchify(got, 16), _t(patches), rtol=0,
                               atol=0)


def test_conv_patch_zB_relprop(x64):
    """Per-image pixel bounds (the second image on another scale)."""
    rng = np.random.RandomState(11)
    img = rng.randn(2, 3, 32, 48)
    img[1] *= 3.0
    w = rng.randn(3 * 16 * 16, 8) * 0.05
    R = rng.randn(2, 6, 8)
    got = trp.conv_patch_zB_relprop(_t(img), _t(w), _t(R), 16)
    assert got.shape == img.shape
    for i in range(2):
        _close(got[i], jrp.conv_patch_zB_relprop(
            jnp.asarray(img[i]), jnp.asarray(w), jnp.asarray(R[i]), 16))


@pytest.mark.parametrize("start_layer", [0, 2])
@pytest.mark.parametrize("row_normalize", [False, True])
def test_compute_rollout(x64, start_layer, row_normalize):
    rng = np.random.RandomState(9)
    cams = np.abs(rng.randn(2, 4, 9, 9)) * 0.1
    got = trp.compute_rollout(_t(cams), start_layer, row_normalize)
    for i in range(2):
        _close(got[i], jrp.compute_rollout(jnp.asarray(cams[i]), start_layer,
                                           row_normalize))


@pytest.mark.parametrize("grad_mode", ["enabled", "no_grad"])
def test_zrule(x64, grad_mode):
    """A nonlinear two-input ``f`` (per row, so the batch may share one
    call); under ``torch.no_grad()`` too, as the explain entry points run."""
    rng = np.random.RandomState(12)
    a, b, R = rng.randn(3, 6), rng.randn(3, 6), rng.randn(3, 6)

    def f_t(x, y):
        return torch.tanh(x) * y + x * x

    def f_j(x, y):
        return jnp.tanh(x) * y + x * x

    ctx = torch.no_grad() if grad_mode == "no_grad" else torch.enable_grad()
    with ctx:
        ga, gb = trp.zrule(f_t, (_t(a), _t(b)), _t(R))
        single = trp.zrule(torch.sin, (_t(a),), _t(R))
    for i in range(3):
        wa, wb = jrp.zrule(f_j, (jnp.asarray(a[i]), jnp.asarray(b[i])),
                           jnp.asarray(R[i]))
        _close(ga[i], wa)
        _close(gb[i], wb)
        _close(single[i], jrp.zrule(jnp.sin, (jnp.asarray(a[i]),),
                                    jnp.asarray(R[i])))


def test_add_eye_relprop(x64):
    rng = np.random.RandomState(13)
    x, R = np.abs(rng.randn(2, 3, 7, 7)) * 0.1, rng.randn(2, 3, 7, 7)
    got = trp.add_eye_relprop(_t(x), _t(R))
    for i in range(2):
        _close(got[i], jrp.add_eye_relprop(jnp.asarray(x[i]),
                                           jnp.asarray(R[i])))


@pytest.mark.parametrize("axis", [0, 1])
def test_cat_relprop(x64, axis):
    """Three parts of other sizes along a per-sample axis (the port's axis
    is JAX's + 1)."""
    rng = np.random.RandomState(14)
    sizes = (2, 5, 3)
    parts = [rng.randn(*[(2, s, 4), (2, 4, s)][axis]) for s in sizes]
    R = rng.randn(*[(2, 10, 4), (2, 4, 10)][axis])
    got = trp.cat_relprop([_t(p) for p in parts], axis + 1, _t(R))
    assert [tuple(g.shape) for g in got] == [p.shape for p in parts]
    for i in range(2):
        want = jrp.cat_relprop([jnp.asarray(p[i]) for p in parts], axis,
                               jnp.asarray(R[i]))
        for g, w in zip(got, want):
            _close(g[i], w)


def test_matmul_relprop(x64):
    rng = np.random.RandomState(15)
    a, b, R = rng.randn(2, 3, 5, 4), rng.randn(2, 3, 4, 6), rng.randn(2, 3, 5, 6)
    ga, gb = trp.matmul_relprop(_t(a), _t(b), _t(R))
    for i in range(2):
        wa, wb = jrp.matmul_relprop(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                    jnp.asarray(R[i]))
        _close(ga[i], wa)
        _close(gb[i], wb)


def test_mul_relprop(x64):
    """With a zero factor, as a head mask holds."""
    rng = np.random.RandomState(16)
    a, b, R = rng.randn(2, 4, 5, 5), rng.randn(2, 4, 5, 5), rng.randn(2, 4, 5, 5)
    b[:, 1] = 0.0
    ga, gb = trp.mul_relprop(_t(a), _t(b), _t(R))
    for i in range(2):
        wa, wb = jrp.mul_relprop(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                 jnp.asarray(R[i]))
        _close(ga[i], wa)
        _close(gb[i], wb)


def test_batchnorm2d_relprop(x64):
    rng = np.random.RandomState(17)
    x, R = rng.randn(2, 3, 5, 6), rng.randn(2, 3, 5, 6)
    w, var = rng.randn(3), np.abs(rng.randn(3)) + 0.1
    got = trp.batchnorm2d_relprop(_t(x), _t(w), _t(var), _t(R))
    want = jax.vmap(jrp.batchnorm2d_relprop, in_axes=(0, None, None, 0))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(var), jnp.asarray(R))
    _close(got, want)


@pytest.mark.parametrize("alpha", [1.0, 2.0])
def test_conv_patch_alphabeta_relprop(x64, alpha):
    rng = np.random.RandomState(18)
    img = rng.randn(2, 3, 32, 48)
    w = rng.randn(3 * 16 * 16, 8) * 0.05
    R = rng.randn(2, 6, 8)
    got = trp.conv_patch_alphabeta_relprop(_t(img), _t(w), _t(R), 16, alpha)
    assert got.shape == img.shape
    want = jax.vmap(lambda i, r: jrp.conv_patch_alphabeta_relprop(
        i, jnp.asarray(w), r, 16, alpha))(jnp.asarray(img), jnp.asarray(R))
    _close(got, want)


def test_all_names_match_the_jax_library():
    assert sorted(trp.__all__) == sorted(jrp.__all__)
