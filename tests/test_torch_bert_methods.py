"""The port's six BERT methods and the model options under them against the
JAX package, in float64 on the CPU.

Same weights both ways (JAX ``init_params`` exported with the port's
converter), same inputs (numpy, from a seed: token ids, per-sample padding
masks, class indices with −1 for the argmax). The JAX side runs one
``bert_generator.make_explain_fn`` program (jitted, vmapped) per method,
start layer and option; the methods that do not read the start layer
(``last_layer``, ``full``, ``last_layer_attn``, ``attn_gradcam``) share
one program across start layers. Model-level options (head masks, token
types, ``relprop``, the unfused reverse) are held against JAX's
``forward_collect`` / ``relprop`` / ``reverse_pass`` vmapped over the
batch. Tolerance rtol 1e-8 / atol 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from transformer_explainability_tpu.explain import bert_generator as jbg
from transformer_explainability_tpu.models import bert as jbert
from transformer_explainability_torch import BertExplainer
from transformer_explainability_torch.explain import bert_generator as bg
from transformer_explainability_torch.explain.generator import (
    precision_kwargs)
from transformer_explainability_torch.models import bert as tbert
from transformer_explainability_torch.models.bert import (
    BertConfig, BertForSequenceClassification)
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.params.convert import (
    bert_params_from_jax)

SMALL = dict(vocab_size=97, hidden_size=24, num_layers=3, num_heads=4,
             intermediate_size=48, max_position_embeddings=64, num_labels=4)
METHODS = list(bg.METHODS)
# the methods whose answer depends on start_layer (JAX bert_generator)
ROLLS = ("transformer_attribution", "rollout")
RTOL, ATOL = 1e-8, 1e-12


@pytest.fixture(scope="module", autouse=True)
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


def _model(sd, cfg):
    model = BertForSequenceClassification(cfg, dtype=torch.float64)
    model.load_state_dict(sd)
    model.requires_grad_(False)
    return model


_CASES = {}


def _case(act="gelu"):
    """The small model with activation ``act`` and its batch, made once."""
    if act not in _CASES:
        fields = dict(SMALL, hidden_act=act)
        jcfg, params, sd = _weights(fields)
        ids, mask = _batch(0, 3, 21, SMALL["vocab_size"], [21, 18, 13])
        _CASES[act] = dict(jcfg=jcfg, params=params, sd=sd,
                           cfg=BertConfig(**fields), ids=ids, mask=mask,
                           idx=np.array([2, -1, -1]), rows={})
    return _CASES[act]


def _jax_rows(case, method, start_layer, alpha=1.0, variant="ours"):
    """JAX's rows for one (method, start layer, α, variant), one program
    each (cached across the tests of this file)."""
    key = (method, start_layer if method in ROLLS else None, alpha, variant)
    if key not in case["rows"]:
        fn = jbg.make_explain_fn(case["jcfg"], method, start_layer, alpha,
                                 variant)
        case["rows"][key] = np.asarray(fn(
            case["params"], jnp.asarray(case["ids"], jnp.int32),
            jnp.asarray(case["mask"]), jnp.asarray(case["idx"], jnp.int32)))
    return case["rows"][key]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("start_layer", [0, 2])
@pytest.mark.parametrize("method", METHODS)
def test_methods_match_jax_f64(method, start_layer):
    case = _case()
    ex = BertExplainer(case["sd"], case["cfg"], device="cpu")
    got = ex.explain(case["ids"], case["mask"], case["idx"], method=method,
                     start_layer=start_layer).numpy()
    assert got.shape == (3, 21) and got.dtype == np.float64
    want = _jax_rows(case, method, start_layer)
    # attn_gradcam is 0/0 on a map with no positive entry, in JAX too
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(want).any()
    _close(got, want)


@pytest.mark.parametrize("method", ["full", "last_layer",
                                    "transformer_attribution"])
def test_lrp_variant_matches_jax_f64(method):
    case = _case()
    ex = BertExplainer(case["sd"], case["cfg"], device="cpu", variant="lrp")
    got = ex.explain(case["ids"], case["mask"], case["idx"], method=method,
                     start_layer=0)
    _close(got, _jax_rows(case, method, 0, variant="lrp"))


@pytest.mark.parametrize("method", ["transformer_attribution", "full"])
def test_alpha_two_matches_jax_f64(method):
    case = _case()
    ex = BertExplainer(case["sd"], case["cfg"], device="cpu")
    got = ex.explain(case["ids"], case["mask"], case["idx"], method=method,
                     start_layer=0, alpha=2.0)
    _close(got, _jax_rows(case, method, 0, alpha=2.0))


@pytest.mark.parametrize("method", ["transformer_attribution",
                                    "attn_gradcam"])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_activations_match_jax_f64(act, method):
    """The activation in the forward, its derivative in the class gradient,
    both in ``transformer_attribution``."""
    case = _case(act)
    ex = BertExplainer(case["sd"], case["cfg"], device="cpu")
    got = ex.explain(case["ids"], case["mask"], case["idx"], method=method,
                     start_layer=0).numpy()
    want = _jax_rows(case, method, 0)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    _close(got, want)


def _head_mask(cfg):
    hm = np.ones((cfg.num_layers, cfg.num_heads))
    hm[1, 2] = 0.0
    hm[2, 0] = 0.5
    return hm


def _jax_forward(case, head_mask=None, token_types=None):
    def one(ids, mask, tt):
        return jbert.forward_collect(case["params"], ids, mask, case["jcfg"],
                                     token_type_ids=tt, head_mask=hm)
    hm = None if head_mask is None else jnp.asarray(head_mask)
    tt = (np.zeros_like(case["ids"]) if token_types is None
          else token_types)
    return jax.jit(jax.vmap(one))(jnp.asarray(case["ids"], jnp.int32),
                                  jnp.asarray(case["mask"]),
                                  jnp.asarray(tt, jnp.int32))


def _onehot(logits, idx, n):
    am = np.asarray(logits).argmax(-1)
    return np.eye(n)[np.where(idx >= 0, idx, am)]


@pytest.mark.parametrize("variant", ["ours", "lrp"])
def test_head_mask_matches_jax_f64(variant):
    """A head mask with a zero and a half entry through ``forward_collect``
    (logits, per-layer probabilities), ``relprop`` (relevance and the
    per-head maps) and the unfused ``reverse_pass`` (its gradients)."""
    case = _case()
    cfg, jcfg = case["cfg"], case["jcfg"]
    hm = _head_mask(cfg)
    model = _model(case["sd"], cfg)
    ids, mask = torch.from_numpy(case["ids"]), torch.from_numpy(case["mask"])
    logits, res = tbert.forward_collect(model, ids, mask,
                                        head_mask=torch.from_numpy(hm),
                                        keep_probs=True)
    jlogits, jres = _jax_forward(case, head_mask=hm)
    _close(logits, jlogits)
    _close(res.probs, jres.probs)
    onehot = _onehot(jlogits, case["idx"], cfg.num_labels)
    R, cams = tbert.relprop(model, res, torch.from_numpy(onehot),
                            variant=variant, head_mask=torch.from_numpy(hm))
    jhm = jnp.asarray(hm)
    jR, jcams = jax.jit(jax.vmap(lambda r, o: jbert.relprop(
        case["params"], r, o, jcfg, variant=variant, head_mask=jhm)))(
            jres, jnp.asarray(onehot))
    _close(R, jR)
    _close(cams, jcams)
    _, cams2, grads = tbert.reverse_pass(model, res, torch.from_numpy(onehot),
                                         variant=variant,
                                         head_mask=torch.from_numpy(hm))
    _, jcams2, jgrads = jax.jit(jax.vmap(lambda r, o: jbert.reverse_pass(
        case["params"], r, o, jcfg, variant=variant, head_mask=jhm)))(
            jres, jnp.asarray(onehot))
    _close(cams2, jcams2)
    _close(grads, jgrads)
    # the masked head's probabilities carry no gradient and no relevance
    assert not grads[:, 1, 2].any() and not cams[:, 1, 2].any()


def test_token_types_match_jax_f64():
    case = _case()
    model = _model(case["sd"], case["cfg"])
    rng = np.random.RandomState(3)
    types = rng.randint(0, 2, size=case["ids"].shape)
    ids, mask = torch.from_numpy(case["ids"]), torch.from_numpy(case["mask"])
    logits, res = tbert.forward_collect(
        model, ids, mask, token_type_ids=torch.from_numpy(types),
        keep_probs=True)
    jlogits, jres = _jax_forward(case, token_types=types)
    _close(logits, jlogits)
    _close(res.x0, jres.x0)
    _close(res.seq_out, jres.seq_out)
    _close(res.probs, jres.probs)
    _close(model(ids, mask, torch.from_numpy(types)), jlogits)
    # token type 0 everywhere is the default
    zero = tbert.forward_collect(model, ids, mask,
                                 token_type_ids=torch.zeros_like(ids))[0]
    _close(zero, tbert.forward_collect(model, ids, mask)[0], rtol=0, atol=0)
    assert not torch.allclose(zero, logits)


class _Taps(TorchFunctionMode):
    """Adds the next tap to each attention softmax's output: the gradient
    w.r.t. a tap is the gradient w.r.t. that layer's probabilities (JAX's
    ``taps``)."""

    def __init__(self, taps):
        super().__init__()
        self.taps, self.i = taps, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.softmax:
            out = out + self.taps[self.i]
            self.i += 1
        return out


@pytest.mark.parametrize("masked", [False, True])
def test_unfused_reverse_grads_match_autograd(masked):
    """The hand-written gradients of the unfused plain reverse are
    autograd's gradients of the class logit w.r.t. every layer's
    post-softmax probabilities (before the head mask)."""
    case = _case("tanh")
    cfg = case["cfg"]
    model = _model(case["sd"], cfg)
    ids, mask = torch.from_numpy(case["ids"]), torch.from_numpy(case["mask"])
    hm = torch.from_numpy(_head_mask(cfg)) if masked else None
    logits, res = tbert.forward_collect(model, ids, mask, head_mask=hm)
    onehot = torch.from_numpy(_onehot(logits, case["idx"], cfg.num_labels))
    R, cams, grads = tbert.reverse_pass(model, res, onehot,
                                        need_relprop=False, head_mask=hm)
    assert R is None and cams is None
    B, S, L, h = *ids.shape, cfg.num_layers, cfg.num_heads
    taps = [torch.zeros(B, h, S, S, dtype=torch.float64, requires_grad=True)
            for _ in range(L)]
    with torch.enable_grad(), _Taps(taps) as mode:
        out = tbert.forward_collect(model, ids, mask, head_mask=hm)[0]
        want = torch.autograd.grad((out * onehot).sum(), taps)
    assert mode.i == L
    torch.testing.assert_close(grads, torch.stack(want, dim=1), rtol=1e-10,
                               atol=1e-13)


def test_generator_entry_points_agree():
    """The reference ``Generator`` names give ``explain``'s answer for
    their method, and JAX's."""
    case = _case()
    ex = BertExplainer(case["sd"], case["cfg"], device="cpu")
    args = (case["ids"], case["mask"], case["idx"])
    calls = {"last_layer": ex.generate_LRP_last_layer(*args),
             "full": ex.generate_full_lrp(*args),
             "last_layer_attn": ex.generate_attn_last_layer(*args),
             "attn_gradcam": ex.generate_attn_gradcam(*args),
             "rollout": ex.generate_rollout(case["ids"], case["mask"],
                                            index=case["idx"])}
    for method, got in calls.items():
        start = 0 if method == "rollout" else 11 % case["cfg"].num_layers
        want = ex.explain(*args, method=method, start_layer=start)
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        _close(got, _jax_rows(case, method, start))
    fn = bg.make_explain_fn(case["cfg"], "cpu", "full")
    torch.testing.assert_close(fn(ex.model, *args), calls["full"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("method", ["full", "rollout"])
def test_base_width_two_layers_matches_jax_f64(method):
    """BERT-base widths (D=768, h=12, I=3072) at depth 2, S=64, two samples
    padded to different lengths."""
    fields = dict(vocab_size=512, num_layers=2)
    jcfg, params, sd = _weights(fields, key=1)
    ids, mask = _batch(1, 2, 64, 512, [64, 41])
    idx = np.array([-1, 1])
    ex = BertExplainer(sd, BertConfig(**fields), device="cpu")
    got = ex.explain(ids, mask, idx, method=method, start_layer=0)
    want = jbg.make_explain_fn(jcfg, method, 0)(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jnp.asarray(idx, jnp.int32))
    _close(got, want)


@pytest.mark.parametrize("method", METHODS)
def test_launches_per_method(method):
    """Per batch: the rollout kernel once for ``transformer_attribution``
    (pre-reduced maps) and ``rollout`` (the per-head probabilities); no
    kernel for the other methods; no layer kernel at the float32 base."""
    case = _case()
    model = _model(case["sd"], case["cfg"])
    seen = []

    def rollout(cams, *a, **k):
        seen.append(tuple(cams.shape))
        return K.rollout_plain(cams, *a, **k)

    def layer_kernel(*a, **k):
        raise AssertionError("a layer kernel ran at the float32 base")

    ops = K.BertOps(layer_kernel, layer_kernel, layer_kernel, rollout)
    ids, mask = torch.from_numpy(case["ids"]), torch.from_numpy(case["mask"])
    got = bg.explain_batch(model, ids, mask, torch.from_numpy(case["idx"]),
                           0, method, ops=ops)
    L, h, S = case["cfg"].num_layers, case["cfg"].num_heads, 21
    want = {"transformer_attribution": [(3, L, S, S)],
            "rollout": [(3, L, h, S, S)]}.get(method, [])
    assert seen == want
    torch.testing.assert_close(got, bg.explain_batch(
        model, ids, mask, torch.from_numpy(case["idx"]), 0, method),
        rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kw", [
    dict(method="last_layer"), dict(method="full"),
    dict(method="last_layer_attn"), dict(method="rollout"),
    dict(method="attn_gradcam"), dict(variant="lrp"), dict(alpha=2.0),
    dict(act="relu")])
@pytest.mark.parametrize("preset", ["production", "bfloat16"])
def test_reduced_bases_run_only_the_kernel_method(kw, preset):
    """Only ``transformer_attribution`` (``ours``, α=1, GELU) takes the
    layer kernels at a reduced-precision base; everything else runs there
    on JAX's non-kernel path (the plain layers in the preset's modes), as
    it does in float32."""
    kw = dict(kw)
    cfg = dataclasses.replace(BertConfig(**SMALL),
                              hidden_act=kw.pop("act", "gelu"))
    bg.check_supported(cfg, **kw, **precision_kwargs(preset))
    bg.check_supported(cfg, **kw)
    call = dict(method="transformer_attribution", alpha=1.0, variant="ours")
    call.update(kw)
    assert not bg.eligible(cfg, call["method"], call["alpha"],
                           call["variant"], **{
                               k: v for k, v in precision_kwargs(
                                   preset).items()
                               if k != "attn_precision"})


def test_kernel_branch_refuses_what_jax_asserts():
    """A head mask, another activation or a non-fused request on the kernel
    branch raise, as JAX asserts."""
    case = _case()
    model = _model(case["sd"], case["cfg"])
    ids, mask = torch.from_numpy(case["ids"]), torch.from_numpy(case["mask"])
    kw = dict(use_kernel=True, matmul_precision="bfloat16")
    hm = torch.ones(3, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="head_mask"):
        tbert.forward_collect(model, ids, mask, K.BERT_PLAIN_OPS,
                              head_mask=hm, **kw)
    logits, res = tbert.forward_collect(model, ids, mask, K.BERT_PLAIN_OPS,
                                        **kw)
    onehot = torch.eye(4, dtype=torch.float64)[logits.argmax(-1)]
    for bad in (dict(head_mask=hm), dict(variant="lrp"), dict(alpha=2.0),
                dict(need_grads=False)):
        with pytest.raises(ValueError):
            tbert.reverse_pass(model, res, onehot, K.BERT_PLAIN_OPS,
                               **kw, **bad)
    relu = _model(_case("relu")["sd"], _case("relu")["cfg"])
    with pytest.raises(ValueError, match="GELU"):
        tbert.forward_collect(relu, ids, mask, K.BERT_PLAIN_OPS, **kw)
