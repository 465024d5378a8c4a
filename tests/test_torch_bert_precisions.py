"""The port's BERT plain path at the reduced bases and under precision
islands against the JAX package: the mode of every product, and the
structure.

As ``tests/test_torch_vit_precisions.py`` holds ViT (the comparison itself
is :mod:`torch_precision_oracle`'s): JAX's ``bert_generator.explain_single``
is lowered on the CPU, where it takes its non-kernel path (the port takes
its plain path too: every method but ``transformer_attribution``, that one
with ``lrp``, α = 2, an island above the base, or at S > 512 on a config
with more positions). The rollout chain of ``transformer_attribution`` is
JAX's Pallas kernel on its TPU, pinned to HIGHEST, and is lowered so (the
port's is B1, whose plain version on the CPU runs its products through
``precision.product`` at float32); both sets are compared whole, exact
float32 products included; the ``rollout`` method's chain is XLA's at the base in JAX
and the port's plain chain at the base, and is compared. Dead products:
JAX's lowering drops the pooler and the classifier of a method that reads
no class (``last_layer_attn``, ``rollout``), which the port computes, so
their keys are taken out of the port's set (:func:`_dead`).

Then, with every product's rounding turned off, the new paths in float64
against JAX's float64 paths at rtol 1e-8, the default float32 path bitwise
the parent commit's (``tests/golden/torch_float32_paths.npz``), and the
raw ``tensorfloat32`` rules, which no layer kernel runs, raising.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from transformer_explainability_tpu.explain import bert_generator as jbg
from transformer_explainability_tpu.models import bert as jbert
from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_torch import BertExplainer
from transformer_explainability_torch.explain import bert_generator as bg
from transformer_explainability_torch.explain.generator import (
    precision_kwargs)
from transformer_explainability_torch.models.bert import BertConfig
from transformer_explainability_torch.params.convert import (
    bert_params_from_jax)

from torch_precision_oracle import (
    assert_same_products, jax_products, port_products, rounding_off)

# distinct product shapes: D = 32, 2 heads of 16, I = 64, 3 labels; room
# for S = 520 > 512
TINY = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=600, num_labels=3)
SMALL = dict(vocab_size=97, hidden_size=24, num_layers=3, num_heads=4,
             intermediate_size=48, max_position_embeddings=600, num_labels=4)
GOLDEN_SMALL = dict(SMALL, max_position_embeddings=64)
RTOL, ATOL = 1e-8, 1e-12
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_float32_paths.npz")
LONG = bg.KERNEL_MAX_SEQ + 8

OTHERS = [m for m in bg.METHODS if m != "transformer_attribution"]
ISLAND = dict(matmul_precision="bfloat16", relprop_precision="float32")
CASES = ([(m, p, {}, 21) for p in ("bfloat16", "production")
          for m in OTHERS]
         + [("transformer_attribution", p, {}, LONG)
            for p in ("bfloat16", "production")]
         + [("rollout", "production", {}, LONG)]
         + [("transformer_attribution", p, kw, 21)
            for p in ("bfloat16", "production")
            for kw in (dict(variant="lrp"), dict(alpha=2.0))]
         + [("transformer_attribution", "island", {}, 21)])


def _kwargs(preset):
    return dict(ISLAND) if preset == "island" else precision_kwargs(preset)


def _weights(fields, dtype=np.float32):
    jcfg = jbert.BertConfig(**fields)
    tree = jax.tree.map(lambda a: np.asarray(a).astype(dtype),
                        jbert.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), bert_params_from_jax(
        tree, BertConfig(**fields))


def _tokens(B, S, vocab, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, size=(B, S))
    lengths = [S, S - 5][:B]
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    return ids, mask


def _dead(method, cfg):
    """The keys of the port's products that are dead for ``method``: the
    pooler's and the classifier's, where the method reads no class."""
    if bg.METHODS[method] != (False, False):
        return set()
    D = cfg["hidden_size"]
    return {(1, D, (1, D)), (1, D, (1, cfg["num_labels"]))}


@pytest.fixture
def pinned_chain(monkeypatch):
    chain = pk.rollout_from_grad_cam

    def pinned(*a, **kw):
        with jax.default_matmul_precision("float32"):
            return chain(*a, **kw)

    monkeypatch.setattr(pk, "rollout_from_grad_cam", pinned)


def _case_id(c):
    m, p, kw, S = c
    return "-".join([m, p, f"S={S}"] + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_bert_products_follow_jax_lowered_program(pinned_chain, case):
    method, preset, kw, S = case
    pkw = _kwargs(preset)
    jcfg, params, sd = _weights(TINY)
    ids, mask = _tokens(1, S, TINY["vocab_size"])
    lowered = jax_products(
        lambda p, i, m, k: jbg.explain_single(
            p, i, m, k, jcfg, method=method, start_layer=0, **kw, **pkw),
        params, jnp.asarray(ids[0], jnp.int32), jnp.asarray(mask[0]),
        jnp.int32(1))
    ex = BertExplainer(sd, BertConfig(**TINY), "cpu",
                       variant=kw.get("variant", "ours"), **pkw)
    with port_products() as seen:
        row = ex.explain(ids, mask, [1], method=method, start_layer=0,
                         alpha=kw.get("alpha", 1.0))
    assert row.shape == (1, S)
    dead = _dead(method, TINY)
    assert_same_products({p for p in seen if p[0] not in dead}, lowered)
    assert {m for _, m in seen} - {"float32"}, "no reduced product ran"


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


F64_CASES = ([(m, "production", {}, 21) for m in OTHERS]
             + [("transformer_attribution", "production", {}, LONG),
                ("transformer_attribution", "bfloat16", dict(variant="lrp"),
                 21),
                ("transformer_attribution", "production", dict(alpha=2.0),
                 21),
                ("transformer_attribution", "island", {}, 21)])


@pytest.mark.parametrize("case", F64_CASES,
                         ids=[_case_id(c) for c in F64_CASES])
def test_bert_new_paths_match_jax_f64(x64, case):
    method, preset, kw, S = case
    pkw = _kwargs(preset)
    jcfg, params, sd = _weights(SMALL, np.float64)
    ids, mask = _tokens(2, S, SMALL["vocab_size"], seed=1)
    mask = mask.astype(np.float64)
    idx = np.array([2, -1])
    fn = jax.jit(jax.vmap(lambda p, i, m, k: jbg.explain_single(
        p, i, m, k, jcfg, method=method, start_layer=0, **kw, **pkw),
        in_axes=(None, 0, 0, 0)))
    want = np.asarray(fn(params, jnp.asarray(ids, jnp.int32),
                         jnp.asarray(mask), jnp.asarray(idx, jnp.int32)))
    ex = BertExplainer(sd, BertConfig(**SMALL), "cpu",
                       variant=kw.get("variant", "ours"), **pkw)
    with rounding_off():
        got = ex.explain(ids, mask, idx, method=method, start_layer=0,
                         alpha=kw.get("alpha", 1.0)).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bert_float32_path_is_bitwise_the_parents():
    """Every BERT method (and lrp, α = 2) of the default float32 path,
    float32 on the CPU, bitwise as the parent commit computed it."""
    gold = np.load(GOLDEN)
    _, _, sd = _weights(GOLDEN_SMALL)
    rng = np.random.RandomState(0)
    ids = rng.randint(5, SMALL["vocab_size"], size=(2, 21))
    mask = (np.arange(21)[None, :] < np.array([21, 13])[:, None]).astype(
        np.float32)
    ex = BertExplainer(sd, BertConfig(**GOLDEN_SMALL), "cpu")
    for m in bg.METHODS:
        got = ex.explain(ids, mask, [1, -1], method=m, start_layer=0)
        np.testing.assert_array_equal(got.numpy(), gold[f"bert_{m}"])
    np.testing.assert_array_equal(
        ex.explain(ids, mask, [1, -1], alpha=2.0, start_layer=0).numpy(),
        gold["bert_alpha2"])
    lrp = BertExplainer(sd, BertConfig(**GOLDEN_SMALL), "cpu",
                        variant="lrp")
    np.testing.assert_array_equal(
        lrp.explain(ids, mask, [1, -1], start_layer=0).numpy(),
        gold["bert_lrp"])


def test_raw_tensorfloat32_rules_raise():
    """``transformer_attribution`` at the raw ``tensorfloat32`` base within
    the layer kernels' lengths has no kernel mode for its bf16×3 rules
    (ROADMAP B item 1); the other methods, and it above 512 tokens, run on
    the plain layers."""
    _, _, sd = _weights(TINY)
    ex = BertExplainer(sd, BertConfig(**TINY), "cpu",
                       matmul_precision="tensorfloat32")
    ids, mask = _tokens(1, 21, TINY["vocab_size"])
    with pytest.raises(NotImplementedError,
                       match="ROADMAP B, raw tensorfloat32"):
        ex.explain(ids, mask, [1])
    assert ex.explain(ids, mask, [1], method="full").shape == (1, 21)
    ids, mask = _tokens(1, LONG, TINY["vocab_size"])
    assert ex.explain(ids, mask, [1], start_layer=0).shape == (1, LONG)
