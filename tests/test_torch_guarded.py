"""The port's guarded mode (ViT) against the JAX package's.

Same weights both ways (JAX ``init_params`` at JAX's guarded-test size,
exported with ``vit_params_from_jax``), same inputs (numpy, from a seed),
on the CPU. The guard's numpy side (the constants, ``calibrate_envelope``,
``_envelope_flags``, ``_batch_corr``, ``CHAOS_STATS``) is held bitwise to
JAX's on JAX's committed calibration diagnostics; the exact-CPU verifier to
JAX's at JAX's own tolerance (rtol 1e-5, atol 1e-7, float32); on JAX's
uint8 test frames, whose maps a one-ulp input change moves by 1e-3, in
float64 at rtol 1e-8, JAX's verifier fed the port's normalised images
(within one float32 ulp of JAX's: its XLA program divides by multiplying).

The guarded functions are held to JAX's with their fast program at the
float32 base in both packages (the precision overrides), so that the two
packages compute the same function on the CPU: JAX's CPU ``production``
runs exact float32 products, the port's rounds its bf16 and bf16×3 products
as the card does. Thresholds are forced as JAX's tests force them (2.0:
every row flagged; -2.0: none), and calibrated envelope bounds are taken
from JAX's diagnostics. The port's own ``production`` program is held by
the flag machinery: heatmaps and scores bitwise those of its programs.
"""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain import generator as jgen
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_torch.explain import generator as tgen
from transformer_explainability_torch.models import vit as tvit
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

SMALL = dict(img_size=32, embed_dim=64, depth=3, num_heads=4, num_classes=10)
JCFG = dataclasses.replace(jvit.VIT_BASE_16_224, **SMALL)
CFG = dataclasses.replace(tvit.VIT_BASE_16_224, **SMALL)
RTOL, ATOL = 1e-5, 1e-7
# the fast program at the float32 base: what JAX's production is on the CPU
F32_BASE = dict(matmul_precision="float32", relprop_precision=None,
                attn_precision=None, mlp_precision=None)
FLAG_ALL = {f: (np.inf, -np.inf) for f in tgen.DIAG_FIELDS}
N_VALID = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = os.path.join(REPO, "experiments", "data",
                     "guarded_envelope_calib_diag.npy")


@pytest.fixture(scope="module")
def setup():
    params = jvit.init_params(jax.random.PRNGKey(0), JCFG)
    model = tvit.VisionTransformer(CFG, device="cpu")
    model.load_state_dict(vit_params_from_jax(
        jax.tree.map(np.asarray, params), CFG))
    model.requires_grad_(False)
    rng = np.random.RandomState(0)
    imgs = rng.randn(4, 3, 32, 32).astype(np.float32)
    idx = np.array([1, -1, 3, 0])
    return params, model, imgs, idx


@pytest.fixture(scope="module")
def jax_diag(setup):
    params, _, imgs, idx = setup
    fn = jgen.make_explain_fn(JCFG, "transformer_attribution",
                              with_diagnostics=True)
    return np.asarray(fn(params, jnp.asarray(imgs), jnp.asarray(idx))[1])


# ------------------------------------------------------- the numpy side


def test_constants_are_jax_values():
    assert tgen.STRICT_AGREEMENT == jgen.STRICT_AGREEMENT
    assert tgen.ENVELOPE_BOUNDS == jgen.ENVELOPE_BOUNDS
    assert tuple(tgen.DIAG_FIELDS) == tuple(jgen.DIAG_FIELDS)
    assert list(tgen.CHAOS_STATS) == list(jgen.CHAOS_STATS)


def test_guard_numpy_side_bitwise_on_jax_calibration():
    """calibrate_envelope, _envelope_flags (JAX's bounds and bounds
    calibrated on half the rows), _batch_corr and every CHAOS_STATS score
    on JAX's committed diagnostics: bitwise."""
    diag = np.load(CALIB)
    for margin in (1.3, 1.5):
        assert (tgen.calibrate_envelope(diag[:48], margin)
                == jgen.calibrate_envelope(diag[:48], margin))
    calibrated = jgen.calibrate_envelope(diag[:48])
    for bounds in (jgen.ENVELOPE_BOUNDS, calibrated):
        a = tgen._envelope_flags(diag, bounds)
        np.testing.assert_array_equal(a, jgen._envelope_flags(diag, bounds))
    assert tgen._envelope_flags(diag[48:], calibrated).any()
    a, b = diag[:48], diag[48:]
    np.testing.assert_array_equal(tgen._batch_corr(a, b),
                                  jgen._batch_corr(a, b))
    d64 = diag.astype(np.float64)
    for name, f in tgen.CHAOS_STATS.items():
        np.testing.assert_array_equal(f(d64), jgen.CHAOS_STATS[name](d64))


# ------------------------------------------------ the exact-CPU verifier


def _frames():
    """JAX's uint8 test frames: on these a one-ulp change of the input moves
    the maps by about 1e-3 relative (JAX's test says so), so float32 runs of
    two implementations are compared in float64 here."""
    return np.random.RandomState(7).randint(0, 256, (4, 32, 32, 3),
                                            dtype=np.uint8)


def _normalised(u8):
    """The port's normalisation of uint8 frames, as (B, C, H, W) numpy:
    within one float32 ulp of JAX's (whose XLA program divides by
    multiplying), and what JAX's verifier is fed below."""
    ours = tgen.preprocess_uint8(torch.as_tensor(u8)).numpy()
    theirs = np.stack([np.asarray(jgen.preprocess_uint8(jnp.asarray(f)))
                       for f in u8])
    np.testing.assert_array_max_ulp(ours, theirs, maxulp=1)
    return ours


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(setup):
    """The setup's weights in float64: (JAX tree, port model)."""
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                          setup[0])
    model = tvit.VisionTransformer(CFG, device="cpu", dtype=torch.float64)
    model.load_state_dict(vit_params_from_jax(
        jax.tree.map(np.asarray, params), CFG))
    model.requires_grad_(False)
    return params, model


def test_cpu_exact_fn_matches_jax(setup):
    params, model, imgs, idx = setup
    ours = tgen.make_cpu_exact_fn(CFG)
    theirs = jgen.make_cpu_exact_fn(JCFG)
    a = np.stack([ours(model, imgs[i], idx[i]) for i in range(4)])
    b = np.stack([theirs(params, imgs[i], idx[i]) for i in range(4)])
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert ours.copy.calls == 4


def test_cpu_exact_fn_uint8_matches_jax(setup, x64):
    """The uint8 wire format: the port's verifier on raw frames (in the
    model's dtype, float64 here) against JAX's on the same normalised
    images, rtol 1e-8."""
    params, model = _f64(setup)
    u8, idx = _frames(), setup[3]
    jimgs = _normalised(u8).astype(np.float64)
    ours = tgen.make_cpu_exact_fn(CFG, preprocess="uint8")
    theirs = jgen.make_cpu_exact_fn(JCFG)
    a = np.stack([ours(model, u8[i], idx[i]) for i in range(4)])
    b = np.stack([theirs(params, jimgs[i], idx[i]) for i in range(4)])
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-14)


def test_cpu_exact_fn_runs_on_the_cpu_copy_of_the_model(setup):
    """The verifier is pinned to the CPU and copies the model once; a
    weight changed in place is copied again (the cache keys on identity
    and on each tensor's version)."""
    _, model, imgs, idx = setup
    m = tvit.VisionTransformer(CFG, device="cpu")
    m.load_state_dict(model.state_dict())
    m.requires_grad_(False)
    fn = tgen.make_cpu_exact_fn(CFG)
    first = fn(m, torch.as_tensor(imgs[0]), 1)
    np.testing.assert_array_equal(first, fn(m, imgs[0], 1))
    assert fn.copy.calls == 2
    with torch.no_grad():
        m.blocks[0].attn.proj.weight.mul_(2.0)
    moved = fn(m, imgs[0], 1)
    fresh = tgen.make_cpu_exact_fn(CFG)(m, imgs[0], 1)
    np.testing.assert_array_equal(moved, fresh)
    assert not np.array_equal(moved, first)


def test_cpu_exact_fn_concurrent_first_call(setup, monkeypatch):
    """The copy is made under a lock: a second thread arriving while the
    first one fills the cache waits for it and gets the same model (JAX's
    round-5e race; the load is slowed to hold the window open)."""
    _, model, imgs, idx = setup
    fn = tgen.make_cpu_exact_fn(CFG)
    real_load = tvit.VisionTransformer.load_state_dict
    loads = []

    def slow_load(self, sd, *a, **kw):
        loads.append(1)
        time.sleep(0.5)
        return real_load(self, sd, *a, **kw)

    monkeypatch.setattr(tvit.VisionTransformer, "load_state_dict", slow_load)
    outs, errs = [], []

    def call():
        try:
            outs.append(fn(model, imgs[0], 1))
        except Exception as e:                 # the failure mode
            errs.append(e)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and len(outs) == 2 and len(loads) == 1
    np.testing.assert_array_equal(outs[0], outs[1])


# -------------------------------------------------- the guarded function


# each JAX guarded function compiles its programs anew: the cases cover
# both thresholds, both fallbacks and both kinds of bounds, with and
# without flagged rows, two a mode
@pytest.mark.parametrize("agreement,fallback", [(2.0, "sync"),
                                                (-2.0, "defer")])
def test_guarded_strict_matches_jax(setup, agreement, fallback):
    """Strict mode, the fast program at the float32 base in both packages:
    heatmaps (the CPU re-runs of flagged rows spliced in with sync), flags
    and scores as JAX's, pad rows (n_valid) never flagged."""
    params, model, imgs, idx = setup
    kw = dict(mode="strict", agreement=agreement, fallback=fallback,
              return_info=True, **F32_BASE)
    heat, info = tgen.make_guarded_explain_fn(CFG, "cpu", **kw)(
        model, imgs, idx, n_valid=N_VALID)
    jheat, jinfo = jgen.make_guarded_explain_fn(JCFG, **kw)(
        params, jnp.asarray(imgs), jnp.asarray(idx), n_valid=N_VALID)
    np.testing.assert_array_equal(info["flagged"], jinfo["flagged"])
    assert info["flagged"].sum() == (N_VALID if agreement > 1 else 0)
    np.testing.assert_allclose(info["score"], jinfo["score"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(heat, jheat, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bounds,fallback", [("flag all", "defer"),
                                             ("calibrated", "sync")])
def test_guarded_envelope_matches_jax(setup, jax_diag, bounds, fallback):
    """Envelope mode with bounds that flag every row and with bounds
    calibrated on JAX's diagnostics of the batch (margin 1.5: none
    flagged); score = g_growth."""
    params, model, imgs, idx = setup
    b = (FLAG_ALL if bounds == "flag all"
         else jgen.calibrate_envelope(jax_diag, margin=1.5))
    kw = dict(mode="envelope", envelope_bounds=b, fallback=fallback,
              return_info=True, **F32_BASE)
    heat, info = tgen.make_guarded_explain_fn(CFG, "cpu", **kw)(
        model, imgs, idx, n_valid=N_VALID)
    jheat, jinfo = jgen.make_guarded_explain_fn(JCFG, **kw)(
        params, jnp.asarray(imgs), jnp.asarray(idx), n_valid=N_VALID)
    np.testing.assert_array_equal(info["flagged"], jinfo["flagged"])
    assert info["flagged"].sum() == (N_VALID if bounds == "flag all" else 0)
    np.testing.assert_allclose(info["score"], jinfo["score"], rtol=RTOL)
    np.testing.assert_allclose(heat, jheat, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["strict", "envelope"])
def test_guarded_production_flag_machinery(setup, mode):
    """The port's production program (its bf16 roundings on the CPU, as on
    the card) with the default thresholds, defer: heatmaps bitwise the
    production program's; strict scores bitwise the corr of the production
    and float32 programs' maps and flags = score < STRICT_AGREEMENT;
    envelope flags = the diagnostics outside ENVELOPE_BOUNDS, score their
    g_growth."""
    _, model, imgs, idx = setup
    prod = tgen.precision_kwargs("production")
    heat, info = tgen.make_guarded_explain_fn(
        CFG, "cpu", mode=mode, fallback="defer", return_info=True)(
            model, imgs, idx)
    if mode == "strict":
        want = tgen.make_explain_fn(CFG, "cpu", **prod)(model, imgs, idx)
        f32 = tgen.make_explain_fn(CFG, "cpu")(model, imgs, idx)
        score = tgen._batch_corr(want.numpy(), f32.numpy())
        flagged = score < tgen.STRICT_AGREEMENT
    else:
        want, diag = tgen.make_explain_fn(CFG, "cpu", with_diagnostics=True,
                                          **prod)(model, imgs, idx)
        diag = diag.numpy().astype(np.float64)
        score, flagged = diag[:, 6], tgen._envelope_flags(
            diag, tgen.ENVELOPE_BOUNDS)
    np.testing.assert_array_equal(heat, want.numpy())
    np.testing.assert_array_equal(info["score"], score)
    np.testing.assert_array_equal(info["flagged"], flagged)


def test_guarded_sync_reruns_only_flagged_real_rows(setup):
    """agreement=2.0, n_valid=2: the CPU verifier runs twice, pad rows keep
    the production program's heatmap bitwise, re-run rows are the
    verifier's."""
    _, model, imgs, idx = setup
    g = tgen.make_guarded_explain_fn(CFG, "cpu", agreement=2.0)
    heat = g(model, imgs, idx, n_valid=2)
    assert g.cpu_exact.copy.calls == 2
    prod = tgen.make_explain_fn(CFG, "cpu", **tgen.precision_kwargs(
        "production"))(model, imgs, idx).numpy()
    np.testing.assert_array_equal(heat[2:], prod[2:])
    exact = tgen.make_cpu_exact_fn(CFG)
    for i in range(2):
        np.testing.assert_array_equal(heat[i], exact(model, imgs[i], idx[i]))


def test_guarded_uint8_reaches_every_program(setup, x64):
    """preprocess='uint8' through the guarded function reaches the fast
    program, the verifier and the CPU fallback (JAX's reaches the fast
    program alone, ROADMAP C3): the re-run rows are the uint8 CPU
    verifier's, held to JAX's verifier on the same normalised images
    (float64, rtol 1e-8)."""
    params, model = _f64(setup)
    idx, u8 = setup[3], _frames()
    heat, info = tgen.make_guarded_explain_fn(
        CFG, "cpu", agreement=2.0, preprocess="uint8", return_info=True)(
            model, u8, idx, n_valid=2)
    assert info["flagged"].tolist() == [True, True, False, False]
    exact = tgen.make_cpu_exact_fn(CFG, preprocess="uint8")
    jexact = jgen.make_cpu_exact_fn(JCFG)
    jimgs = _normalised(u8).astype(np.float64)
    for i in range(2):
        np.testing.assert_array_equal(heat[i], exact(model, u8[i], idx[i]))
        np.testing.assert_allclose(heat[i], jexact(params, jimgs[i], idx[i]),
                                   rtol=1e-8, atol=1e-14)


def test_guarded_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tgen.make_guarded_explain_fn(CFG, "cpu", mode="nope")
    with pytest.raises(ValueError):
        tgen.make_guarded_explain_fn(CFG, "cpu", mode="envelope",
                                     fallback="asap")
    with pytest.raises(ValueError):
        tgen.make_guarded_explain_fn(CFG, "cpu", preprocess="float16")
    assert set(tgen.ENVELOPE_BOUNDS) == set(tgen.DIAG_FIELDS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tgen.make_guarded_explain_fn(CFG, "cuda")
