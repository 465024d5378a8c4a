"""The port's guarded BERT explanations (strict mode) against the JAX
package's.

JAX's BERT guarded-test configuration and inputs (token ids from a seed, one
padded row, −1 indices), the same weights both ways (``bert_params_from_jax``),
on the CPU. The exact-CPU verifier is held to JAX's at JAX's own tolerance
(rtol 1e-5, atol 1e-7, float32). The guarded function is held to JAX's with
its fast program at the float32 base in both packages (JAX's CPU
``production`` runs exact float32 products, the port's rounds as the card
does), the threshold forced to 2.0 (every row flagged) and −2.0 (none); the
port's own ``production`` program by its flag machinery, bitwise.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from transformer_explainability_tpu.explain import bert_generator as jbg
from transformer_explainability_tpu.models import bert as jbert
from transformer_explainability_torch.explain import bert_generator as tbg
from transformer_explainability_torch.explain import generator as tgen
from transformer_explainability_torch.models import bert as tbert
from transformer_explainability_torch.params.convert import (
    bert_params_from_jax)

SMALL = dict(vocab_size=100, hidden_size=32, num_layers=3, num_heads=4,
             intermediate_size=64, max_position_embeddings=40, num_labels=2)
JCFG = jbert.BertConfig(**SMALL)
CFG = tbert.BertConfig(**SMALL)
S = 12
START = CFG.num_layers - 1
RTOL, ATOL = 1e-5, 1e-7
F32_BASE = dict(matmul_precision="float32", relprop_precision=None,
                attn_precision=None, mlp_precision=None)


@pytest.fixture(scope="module")
def setup():
    params = jbert.init_params(jax.random.PRNGKey(0), JCFG)
    model = tbert.BertForSequenceClassification(CFG, device="cpu")
    model.load_state_dict(bert_params_from_jax(
        jax.tree.map(np.asarray, params), CFG))
    model.requires_grad_(False)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, CFG.vocab_size, (4, S)).astype(np.int32)
    mask = np.ones((4, S), np.float32)
    mask[1, S // 2:] = 0.0
    idx = np.array([1, -1, 0, 1], np.int32)
    return params, model, ids, mask, idx


def test_cpu_exact_bert_fn_matches_jax(setup):
    params, model, ids, mask, idx = setup
    ours = tbg.make_cpu_exact_bert_fn(CFG, start_layer=START)
    theirs = jbg.make_cpu_exact_bert_fn(JCFG, start_layer=START)
    a = np.stack([ours(model, ids[i], mask[i], idx[i]) for i in range(4)])
    b = np.stack([theirs(params, ids[i], mask[i], idx[i]) for i in range(4)])
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert ours.copy.calls == 4


@pytest.mark.parametrize("agreement,fallback,n_valid",
                         [(2.0, "sync", None), (2.0, "defer", 2),
                          (-2.0, "sync", None)])
def test_guarded_bert_matches_jax(setup, agreement, fallback, n_valid):
    params, model, ids, mask, idx = setup
    kw = dict(start_layer=START, agreement=agreement, fallback=fallback,
              return_info=True, **F32_BASE)
    heat, info = tbg.make_guarded_bert_explain_fn(CFG, "cpu", **kw)(
        model, ids, mask, idx, n_valid=n_valid)
    jheat, jinfo = jbg.make_guarded_bert_explain_fn(JCFG, **kw)(
        params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(idx),
        n_valid=n_valid)
    np.testing.assert_array_equal(info["flagged"], jinfo["flagged"])
    flags = 0 if agreement < 1 else (n_valid or 4)
    assert info["flagged"].sum() == flags
    np.testing.assert_allclose(info["score"], jinfo["score"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(heat, jheat, rtol=RTOL, atol=ATOL)


def test_guarded_bert_production_flag_machinery(setup):
    """The port's production program with the default threshold, defer:
    rows bitwise the production program's, scores bitwise the corr of the
    production and float32 programs' rows, flags = score <
    STRICT_AGREEMENT."""
    _, model, ids, mask, idx = setup
    heat, info = tbg.make_guarded_bert_explain_fn(
        CFG, "cpu", start_layer=START, fallback="defer", return_info=True)(
            model, ids, mask, idx)
    prod = tbg.make_explain_fn(CFG, "cpu", start_layer=START,
                               **tgen.precision_kwargs("production"))(
        model, ids, mask, idx).numpy()
    f32 = tbg.make_explain_fn(CFG, "cpu", start_layer=START)(
        model, ids, mask, idx).numpy()
    np.testing.assert_array_equal(heat, prod)
    score = tgen._batch_corr(prod, f32)
    np.testing.assert_array_equal(info["score"], score)
    np.testing.assert_array_equal(info["flagged"],
                                  score < tgen.STRICT_AGREEMENT)


def test_guarded_bert_sync_reruns_only_flagged_real_rows(setup):
    _, model, ids, mask, idx = setup
    g = tbg.make_guarded_bert_explain_fn(CFG, "cpu", start_layer=START,
                                         agreement=2.0)
    heat = g(model, ids, mask, idx, n_valid=1)
    assert g.cpu_exact.copy.calls == 1
    prod = tbg.make_explain_fn(CFG, "cpu", start_layer=START,
                               **tgen.precision_kwargs("production"))(
        model, ids, mask, idx).numpy()
    np.testing.assert_array_equal(heat[1:], prod[1:])
    exact = tbg.make_cpu_exact_bert_fn(CFG, start_layer=START)
    np.testing.assert_array_equal(heat[0],
                                  exact(model, ids[0], mask[0], idx[0]))


def test_guarded_bert_rejects_unknown_fallback():
    with pytest.raises(ValueError):
        tbg.make_guarded_bert_explain_fn(CFG, "cpu", fallback="async")


def test_cpu_exact_bert_fn_concurrent_first_call(setup, monkeypatch):
    """Two first calls at once: one copy of the model, the same rows."""
    _, model, ids, mask, idx = setup
    fn = tbg.make_cpu_exact_bert_fn(CFG, start_layer=START)
    real_load = tbert.BertForSequenceClassification.load_state_dict
    loads = []

    def slow_load(self, sd, *a, **kw):
        loads.append(1)
        time.sleep(0.5)
        return real_load(self, sd, *a, **kw)

    monkeypatch.setattr(tbert.BertForSequenceClassification,
                        "load_state_dict", slow_load)
    outs, errs = [], []

    def call():
        try:
            outs.append(fn(model, ids[0], mask[0], 1))
        except Exception as e:                 # the failure mode
            errs.append(e)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and len(outs) == 2 and len(loads) == 1
    np.testing.assert_array_equal(outs[0], outs[1])
