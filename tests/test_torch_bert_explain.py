"""The port's BERT ``transformer_attribution`` slice against the JAX package.

Same weights both ways (JAX ``init_params`` exported with the port's
converter), same inputs (numpy, from a seed: token ids, per-sample padding
masks, −1 indices), float64 on the CPU, where the port's kernel wrappers take
their plain versions. The JAX side runs ``bert_generator.explain_single``
one sample at a time: its XLA path for the ``float32`` preset, and its
kernel path (``use_kernel=True``, the kernels' jnp math on the CPU) for
``production`` and ``bfloat16``. Tolerance rtol 1e-8 / atol 1e-12 (only the
float64 summation order differs). The full BERT-base golden of
``experiments/make_bert_golden.py`` is held at max abs 1e-9.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain.bert_generator import (
    explain_single)
from transformer_explainability_tpu.explain.generator import (
    PRECISION_PRESETS as JAX_PRESETS)
from transformer_explainability_tpu.models import bert as jbert
from transformer_explainability_tpu.params.convert import (
    bert_state_dict_from_params)
from transformer_explainability_torch import BertExplainer
from transformer_explainability_torch.explain import bert_generator as bg
from transformer_explainability_torch.explain.generator import (
    precision_kwargs)
from transformer_explainability_torch.models import bert as tbert
from transformer_explainability_torch.models.bert import (
    BertConfig, BertForSequenceClassification, init_params)
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.params.convert import (
    bert_params_from_jax)

SMALL = dict(vocab_size=97, hidden_size=24, num_layers=3, num_heads=4,
             intermediate_size=48, max_position_embeddings=64, num_labels=4)
PRESETS = ["float32", "production", "bfloat16"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _weights(fields, key=0):
    """(JAX config, JAX f64 pytree, port f64 state dict) of the same init."""
    jcfg = jbert.BertConfig(**fields)
    tree = jax.tree.map(np.asarray,
                        jbert.init_params(jax.random.PRNGKey(key), jcfg))
    tree64 = jax.tree.map(lambda a: a.astype(np.float64), tree)
    sd = bert_params_from_jax(tree64, BertConfig(**fields))
    return jcfg, jax.tree.map(jnp.asarray, tree64), sd


def _batch(seed, B, S, vocab, lengths):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, size=(B, S))
    mask = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float64)
    return ids, mask


def _jax_rows(jcfg, params, ids, mask, idx, preset, start_layer):
    kw = dict(JAX_PRESETS[preset])
    if preset != "float32":
        kw["use_kernel"] = True
    fn = jax.jit(lambda p, i, m, x: explain_single(
        p, i, m, x, jcfg, start_layer=start_layer, **kw))
    return np.stack([np.asarray(fn(params, jnp.asarray(ids[b], jnp.int32),
                                   jnp.asarray(mask[b]), jnp.int32(idx[b])))
                     for b in range(len(ids))])


@pytest.mark.parametrize("start_layer", [0, 2])
@pytest.mark.parametrize("preset", PRESETS)
def test_small_config_matches_jax_f64(x64, preset, start_layer):
    jcfg, params, sd = _weights(SMALL)
    ids, mask = _batch(0, 3, 21, SMALL["vocab_size"], [21, 18, 13])
    idx = np.array([2, -1, -1])
    ex = BertExplainer(sd, BertConfig(**SMALL), device="cpu",
                       **precision_kwargs(preset))
    got = ex.explain(ids, mask, idx, start_layer=start_layer).numpy()
    assert got.shape == (3, 21) and got.dtype == np.float64
    want = _jax_rows(jcfg, params, ids, mask, idx, preset, start_layer)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("preset", PRESETS)
def test_base_width_two_layers_matches_jax_f64(x64, preset):
    """BERT-base widths (D=768, h=12, I=3072) at depth 2, S=64, two samples
    padded to different lengths."""
    fields = dict(vocab_size=512, num_layers=2)
    jcfg, params, sd = _weights(fields, key=1)
    ids, mask = _batch(1, 2, 64, 512, [64, 41])
    idx = np.array([-1, 1])
    ex = BertExplainer(sd, BertConfig(**fields), device="cpu",
                       **precision_kwargs(preset))
    got = ex.generate_LRP(ids, mask, idx, start_layer=0).numpy()
    want = _jax_rows(jcfg, params, ids, mask, idx, preset, 0)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_bert_base_golden_f64():
    """The JAX package's full BERT-base golden (seed-0 weights, vocab 4096,
    the demo sentence) from the port's plain float64 ``float32`` path, with
    the recipe of ``experiments/make_bert_golden.py``."""
    with open(os.path.join(GOLDEN, "bert_demo_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(GOLDEN, "bert_demo_vocab.txt")) as f:
        vocab = f.read().split("\n")
    ids = torch.tensor([[vocab.index(t) for t in meta["tokens"]]])
    mask = torch.ones_like(ids, dtype=torch.float64)
    fields = dict(meta["config"])
    _, _, sd = _weights(fields, key=meta["seed"])
    cfg = BertConfig(**fields)
    model = BertForSequenceClassification(cfg, dtype=torch.float64)
    model.load_state_dict(sd)
    logits = model(ids, mask)
    pred = int(logits.argmax())
    assert pred == meta["pred"]
    expl = bg.explain_batch(model, ids, mask, torch.tensor([pred]),
                            start_layer=meta["start_layer"])[0].numpy()
    expl = (expl - expl.min()) / (expl.max() - expl.min())
    if meta["classifications"][pred] == "NEGATIVE":
        expl = -expl
    want = np.load(os.path.join(GOLDEN, "bert_demo_scores_f64.npy"))
    assert np.abs(expl - want).max() <= 1e-9


def test_bert_params_from_jax_matches_state_dict_export():
    jcfg = jbert.BertConfig(**SMALL)
    tree = jbert.init_params(jax.random.PRNGKey(0), jcfg)
    sd = bert_params_from_jax(jax.tree.map(np.asarray, tree),
                              BertConfig(**SMALL))
    want = bert_state_dict_from_params(tree, jcfg)
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)
    model = BertForSequenceClassification(BertConfig(**SMALL),
                                          dtype=torch.float32)
    model.load_state_dict(sd)                      # strict: every key fits
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_init_params_layout_and_statistics():
    cfg = BertConfig(**SMALL)
    sd = init_params(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    want = bert_state_dict_from_params(
        jbert.init_params(jax.random.PRNGKey(0), jbert.BertConfig(**SMALL)),
        jbert.BertConfig(**SMALL))
    assert sorted(sd) == sorted(want)
    for k in want:
        assert tuple(sd[k].shape) == want[k].shape, k
    w = sd["bert.encoder.layer.0.intermediate.dense.weight"]
    assert w.dtype == torch.float32 and abs(w.std().item() - 0.02) < 0.002
    assert not sd["bert.pooler.dense.bias"].any()


def test_api_entry_points_agree():
    """``explain``, ``generate_LRP`` and ``make_explain_fn`` give one answer;
    1-D inputs and ``indices=None`` (argmax) work; a batch gives each sample
    what it gets alone."""
    _, _, sd = _weights(SMALL, key=2)
    cfg = BertConfig(**SMALL)
    ids, mask = _batch(3, 4, 17, SMALL["vocab_size"], [17, 9, 12, 17])
    for preset in ("float32", "production"):
        ex = BertExplainer(sd, cfg, device="cpu", **precision_kwargs(preset))
        a = ex.explain(ids, mask, start_layer=1)
        b = ex.generate_LRP(ids, mask, [-1] * 4, start_layer=1)
        fn = bg.make_explain_fn(cfg, "cpu", start_layer=1,
                                **precision_kwargs(preset))
        c = fn(ex.model, ids, mask, np.full(4, -1))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
        for i in range(4):
            alone = ex.explain(ids[i], mask[i], start_layer=1)
            torch.testing.assert_close(a[i:i + 1], alone, rtol=1e-9,
                                       atol=1e-12)
        assert torch.isfinite(a).all()
        assert (a[:, 0] == a.min(dim=1).values).all()


@pytest.mark.parametrize("preset,kernels", [
    ("float32", False), ("production", True), ("bfloat16", True)])
def test_presets_take_the_layer_kernels_and_prepare_once(preset, kernels):
    """A bfloat16 / tensorfloat32 base calls B7, B8 and B9 once per layer
    per batch (plain on the CPU, through the ops table); float32 none of
    them. The rollout runs once. Each weight is split once."""
    cfg = BertConfig(**SMALL)
    model = BertForSequenceClassification(cfg, dtype=torch.float32)
    model.load_state_dict(init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    calls = {k: 0 for k in K.BertOps._fields}

    def counted(name, f):
        def g(*a, **k):
            calls[name] += 1
            return f(*a, **k)
        return g

    ops = K.BertOps(*(counted(n, f) for n, f in zip(K.BertOps._fields,
                                                    K.BERT_PLAIN_OPS)))
    ids, mask = (torch.from_numpy(a) for a in _batch(4, 2, 19, 97, [19, 7]))
    kw = precision_kwargs(preset)
    a = bg.explain_batch(model, ids, mask, torch.tensor([-1, 3]), 1, ops=ops,
                         **kw)
    n = cfg.num_layers if kernels else 0
    assert calls == {"bert_layer_fwd_core": n, "bert_out_rev_core": n,
                     "bert_attn_rev_core": n, "rollout_from_grad_cam": 1}
    b = bg.explain_batch(model, ids, mask, torch.tensor([-1, 3]), 1, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    if kernels:
        mode = kw["matmul_precision"]
        w0 = model.layer_params(0, mode).w_qkv
        assert model.layer_params(0, mode).w_qkv[0] is w0[0]
        with torch.no_grad():
            model.bert.encoder.layer[0].attention.self.key.bias.add_(1.0)
        assert model.layer_params(0, mode).w_qkv[0] is not w0[0]


def test_plain_reverse_matches_autograd():
    """The hand-written class gradient of the plain float32 path is
    autograd's gradient of the class logit w.r.t. the attention probs."""
    cfg = BertConfig(**SMALL)
    model = BertForSequenceClassification(cfg, dtype=torch.float64)
    model.load_state_dict({k: v.double() if v.is_floating_point() else v
                           for k, v in init_params(
                               cfg, generator=torch.Generator().manual_seed(5),
                               device="cpu").items()})
    ids, mask = (torch.from_numpy(a) for a in _batch(6, 2, 11, 97, [11, 6]))
    logits, res = tbert.forward_collect(model, ids, mask)
    onehot = torch.nn.functional.one_hot(logits.argmax(-1), 4).double()
    g = torch.zeros_like(res.seq_out)
    g_first = ((onehot @ model.classifier.weight)
               * (1 - res.pooled ** 2)) @ model.bert.pooler.dense.weight
    g[:, 0] = g_first
    layer = model.bert.encoder.layer[-1]
    x_in = res.x_ins[-1].clone().requires_grad_(True)
    att_ln, out, acts = tbert.layer_acts(x_in, None, layer, res.ext_mask, cfg)
    g_in, _ = tbert.layer_backward(g, res.x_ins[-1], att_ln.detach(), acts,
                                   layer, cfg)
    (want,) = torch.autograd.grad((out * g).sum(), x_in)
    torch.testing.assert_close(g_in, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(matmul_precision="tensorfloat32"),
    dict(matmul_precision="float32", attn_precision="bfloat16"),
    dict(matmul_precision="bfloat16", relprop_precision="float32"),
])
def test_unported_options_raise(kw):
    """Raw tensorfloat32 rules have no layer-kernel mode (ROADMAP B); an
    island on the float32 base or above a reduced base runs on the plain
    layers, as in JAX."""
    if kw["matmul_precision"] == "tensorfloat32":
        with pytest.raises(NotImplementedError, match="ROADMAP B"):
            bg.check_supported(BertConfig(**SMALL), **kw)
        # longer than the layer kernels take: the plain layers
        bg.check_supported(BertConfig(**SMALL), **kw,
                           seq_len=bg.KERNEL_MAX_SEQ + 1)
    else:
        cfg = BertConfig(**SMALL)
        bg.check_supported(cfg, **kw)
        assert not (bg.eligible(cfg, "transformer_attribution", 1.0, "ours",
                                kw["matmul_precision"],
                                kw.get("relprop_precision"))
                    and bg.use_kernel_path(bg.KERNEL_MAX_SEQ,
                                           kw["matmul_precision"]))



def test_unported_configs_raise():
    """relu and the rollout method run; S > 512 at a reduced base is
    JAX's non-kernel path, which the plain layers take."""
    bg.check_supported(BertConfig(hidden_act="relu"))
    assert not bg.use_kernel_path(bg.KERNEL_MAX_SEQ + 1, "bfloat16")
    assert not bg.use_kernel_path(bg.KERNEL_MAX_SEQ + 1, "float32")
    assert bg.use_kernel_path(bg.KERNEL_MAX_SEQ, "tensorfloat32")
    ex = BertExplainer(init_params(BertConfig(**SMALL), generator=torch
                                   .Generator().manual_seed(0), device="cpu"),
                       BertConfig(**SMALL), device="cpu")
    roll = ex.generate_rollout(np.zeros((1, 5), int), np.ones((1, 5)))
    assert roll.shape == (1, 5) and torch.isfinite(roll).all()
    with pytest.raises(ValueError, match="unknown method"):
        ex.explain(np.zeros((1, 5), int), np.ones((1, 5)), method="grad")
