"""The port's checkpoint loaders, adapters and model registry against the
JAX package's (``params/convert.py``, ``models/registry.py``).

The files are the ones users hold, written here from seeded JAX weights
through the JAX exporters (``vit_state_dict_from_params``,
``bert_state_dict_from_params``) with ``torch.save`` (as tensors), or by
either package's ``save_vit_npz``. Each file is read by both packages; the
port's state dict must equal ``vit_params_from_jax`` /
``bert_params_from_jax`` of JAX's pytree bit for bit, and a ViT explained
from it in float64 must give JAX ``explain_single``'s map at rtol 1e-8.
The configurations are the JAX harness tests' tiny ViT (img 32, patch 16,
D 32, 2 blocks, 10 classes), its twin without qkv biases and its distilled
twin, and a 2-layer narrow BERT.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain.generator import explain_single
from transformer_explainability_tpu.models import bert as jbert
from transformer_explainability_tpu.models import registry as jreg
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.params import convert as jconv
from transformer_explainability_torch import Explainer, create_model, list_models
from transformer_explainability_torch.models import registry as treg
from transformer_explainability_torch.models.bert import BertConfig
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.params import convert as tconv

TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            num_classes=10)
VARIANTS = {"bias": TINY, "no_bias": dict(TINY, qkv_bias=False),
            "distilled": dict(TINY, distilled=True)}
BERT = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=16, num_labels=3)
# jax.image.resize forms the resize as a contraction with a weight matrix,
# F.interpolate as two-tap sums: their float32 results differ by the
# rounding of the table's magnitude, not of each output, so outputs near 0
# are held to 1e-6 of the table's largest entry besides rtol 1e-6.
# Shrinking, jax.image.resize antialiases; F.interpolate with antialias=True
# computes the same filter: the gaps measured here are 1.8e-7 (one prefix
# row) and 1.6e-7 (two) of the table's largest entry, growing 3.2e-7 and
# 4.1e-7
UP_RTOL = 1e-6
DOWN_GAP = 2e-7


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _seeded_tree(init, jcfg, seed):
    """Seeded float32 numpy leaves in the layout of JAX ``init`` (traced by
    ``jax.eval_shape``, not compiled): the JAX package's pytree of a model
    with other weights than its init draws."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    return jax.tree.map(
        lambda a: (0.02 * rng.randn(*a.shape)).astype(np.float32), shapes)


def _jax_vit(fields, key=0):
    jcfg = jvit.ViTConfig(**fields)
    return jcfg, _seeded_tree(jvit.init_params, jcfg, key)


def _save_pth(path, sd, layout):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save({"flat": sd, "model": {"model": sd},
                "state_dict": {"state_dict": sd, "epoch": 3}}[layout], path)
    return str(path)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.mark.parametrize("layout", ["flat", "model", "state_dict"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_vit_pth_loads_as_jax(tmp_path, layout, variant):
    fields = VARIANTS[variant]
    jcfg, params = _jax_vit(fields)
    path = _save_pth(tmp_path / "vit.pth",
                     jconv.vit_state_dict_from_params(params, jcfg), layout)
    want = tconv.vit_params_from_jax(
        _np_tree(jconv.load_vit_checkpoint(path, jcfg)), ViTConfig(**fields))
    _assert_same(tconv.load_vit_checkpoint(path, ViTConfig(**fields)), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_vit_checkpoint_explains_as_jax_f64(tmp_path, x64, variant):
    fields = VARIANTS[variant]
    jcfg, params = _jax_vit(fields, key=1)
    path = _save_pth(tmp_path / "vit.pth",
                     jconv.vit_state_dict_from_params(params, jcfg), "model")
    # the file holds these float32 weights (the loaders are held to JAX's
    # bitwise above): JAX explains them in float64 directly
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    sd = tconv.load_vit_checkpoint(path, ViTConfig(**fields),
                                   dtype=torch.float64)
    imgs = np.random.RandomState(3).randn(3, 3, 32, 32)
    idx = np.array([2, -1, 7])
    fn = jax.jit(jax.vmap(lambda p, x, i: explain_single(p, x, i, jcfg),
                          in_axes=(None, 0, 0)))
    want = np.asarray(fn(jp, jnp.asarray(imgs), jnp.asarray(idx, jnp.int32)))
    got = Explainer(sd, ViTConfig(**fields), "cpu").explain(
        torch.from_numpy(imgs), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_vit_checkpoint_mismatches_raise(tmp_path):
    jcfg, params = _jax_vit(TINY)
    path = _save_pth(tmp_path / "vit.pth",
                     jconv.vit_state_dict_from_params(params, jcfg), "flat")
    with pytest.raises(ValueError, match="qkv_bias"):
        tconv.load_vit_checkpoint(path, ViTConfig(**TINY, qkv_bias=False))
    with pytest.raises(ValueError, match="distilled"):
        tconv.load_vit_checkpoint(path, ViTConfig(**TINY, distilled=True))
    with pytest.raises(ValueError, match="shape"):
        tconv.load_vit_checkpoint(path, ViTConfig(**dict(TINY, img_size=48)))
    sd = torch.load(path)
    del sd["blocks.1.mlp.fc2.bias"]
    with pytest.raises(KeyError, match="fc2"):
        tconv.vit_params_from_torch_state_dict(sd, ViTConfig(**TINY))


@pytest.mark.parametrize("variant", ["bias", "distilled"])
def test_npz_both_ways_bitwise(tmp_path, variant):
    """JAX's own .npz (keystr keys) read by the port; the port's .npz (timm
    keys) read by JAX."""
    fields = VARIANTS[variant]
    jcfg, params = _jax_vit(fields)
    cfg = ViTConfig(**fields)
    want = tconv.vit_params_from_jax(_np_tree(params), cfg)
    jax_npz = str(tmp_path / "jax.npz")
    jconv.save_vit_npz(jax_npz, params)
    with np.load(jax_npz) as f:
        assert "['blocks']['fc1']['kernel']" in f.files
    _assert_same(tconv.load_vit_checkpoint(jax_npz, cfg), want)
    port_npz = str(tmp_path / "port.npz")
    tconv.save_vit_npz(port_npz, want)
    back = jconv.load_vit_checkpoint(port_npz, jcfg)
    _assert_same(tconv.vit_params_from_jax(_np_tree(back), cfg), want)
    _assert_same(tconv.load_npz_pytree(port_npz, want), want)


def _jax_bert(key=0):
    jcfg = jbert.BertConfig(**BERT)
    return jcfg, _seeded_tree(jbert.init_params, jcfg, key)


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("classifier", [True, False])
def test_bert_bin_loads_as_jax(tmp_path, prefix, classifier):
    jcfg, params = _jax_bert()
    if not classifier:
        params = {k: v for k, v in params.items() if k != "classifier"}
    sd = jconv.bert_state_dict_from_params(params, jcfg, prefix_bert=prefix)
    path = str(tmp_path / "pytorch_model.bin")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    want = tconv.bert_params_from_jax(
        _np_tree(jconv.load_bert_checkpoint(path, jcfg)), BertConfig(**BERT))
    got = tconv.load_bert_checkpoint(path, BertConfig(**BERT))
    _assert_same(got, want)
    assert ("classifier.weight" in got) == classifier
    got_dir = tconv.load_bert_checkpoint(str(tmp_path), BertConfig(**BERT))
    _assert_same(got_dir, want)


def test_bert_safetensors_loads_as_jax(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    jcfg, params = _jax_bert(key=2)
    sd = jconv.bert_state_dict_from_params(params, jcfg)
    st.save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
                 str(tmp_path / "model.safetensors"))
    want = tconv.bert_params_from_jax(
        _np_tree(jconv.load_bert_checkpoint(str(tmp_path), jcfg)),
        BertConfig(**BERT))
    _assert_same(tconv.load_bert_checkpoint(str(tmp_path),
                                            BertConfig(**BERT)), want)


@pytest.mark.parametrize("in_chans", [1, 3, 4])
def test_adapt_first_conv_bitwise(in_chans):
    jcfg, params = _jax_vit(TINY)
    kernel = np.asarray(params["patch_embed"]["kernel"])      # (C·P·P, D)
    want = jconv.adapt_first_conv(kernel, in_chans, 16)
    w = torch.from_numpy(kernel.T.reshape(32, 3, 16, 16).copy())
    got = tconv.adapt_first_conv(w, in_chans)
    assert got.shape == (32, in_chans, 16, 16)
    np.testing.assert_array_equal(got.numpy().reshape(32, -1).T, want)


def test_adapt_classifier():
    rng = np.random.RandomState(0)
    kernel = rng.randn(32, 1001).astype(np.float32)            # (D, classes)
    bias = rng.randn(1001).astype(np.float32)
    w, b = torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias)
    same = tconv.adapt_classifier(w, b, 1001, 1001)
    assert same[0] is w and same[1] is b
    want = jconv.adapt_classifier({"kernel": kernel, "bias": bias}, 1000,
                                  1001)
    got_w, got_b = tconv.adapt_classifier(w, b, 1000, 1001)
    np.testing.assert_array_equal(got_w.numpy().T, np.asarray(want["kernel"]))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want["bias"]))
    # any other size: a new head, trunc-normal std 0.02 cut at ±2σ; the
    # generators differ from JAX's PRNGKey, so shape, zero bias and the cut
    new_w, new_b = tconv.adapt_classifier(
        w, b, 7, 1001, generator=torch.Generator().manual_seed(5))
    ref = jconv.adapt_classifier({"kernel": kernel, "bias": bias}, 7, 1001)
    assert new_w.shape == np.asarray(ref["kernel"]).T.shape == (7, 32)
    assert torch.equal(new_b, torch.zeros(7))
    assert new_w.abs().max() <= 0.04 and 0.01 < new_w.std() < 0.03


@pytest.mark.parametrize("prefix", [1, 2])
@pytest.mark.parametrize("g_old,g_new", [(14, 24), (24, 14)])
def test_resize_pos_embed_matches_jax(prefix, g_old, g_new):
    pe = (np.random.RandomState(prefix).randn(prefix + g_old * g_old, 48)
          * 0.02).astype(np.float32)
    want = jconv.resize_pos_embed(pe, prefix + g_new * g_new, prefix)
    got = tconv.resize_pos_embed(torch.from_numpy(pe)[None],
                                 prefix + g_new * g_new, prefix)
    assert got.shape == (1, prefix + g_new * g_new, 48)
    np.testing.assert_array_equal(got[0, :prefix].numpy(), pe[:prefix])
    scale = np.abs(pe).max()
    if g_new > g_old:
        np.testing.assert_allclose(got[0].numpy(), want, rtol=UP_RTOL,
                                   atol=UP_RTOL * scale)
    else:
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                                   atol=DOWN_GAP * scale)


def test_adapt_pretrained_matches_jax():
    """A 3-channel, 10-class 32-px checkpoint adapted to 1 channel at 48 px
    (grid 2 -> 3), then the head re-drawn for 4 classes (by shape)."""
    src, params = _jax_vit(dict(TINY, distilled=True))
    dst = dict(TINY, distilled=True, img_size=48, in_chans=1)
    cfg = ViTConfig(**dst)
    want = tconv.vit_params_from_jax(_np_tree(jconv.adapt_pretrained(
        params, jvit.ViTConfig(**dst), pretrained_classes=10)), cfg)
    sd = tconv.vit_params_from_jax(_np_tree(params), ViTConfig(**VARIANTS[
        "distilled"]))
    got = tconv.adapt_pretrained(sd, cfg, pretrained_classes=10)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k == "pos_embed":
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-9)
        else:
            assert torch.equal(got[k], want[k]), k
    Explainer(got, cfg, "cpu")                  # loads into the model
    four = tconv.adapt_pretrained(sd, dataclasses.replace(cfg, num_classes=4),
                                  pretrained_classes=10)
    assert four["head.weight"].shape == four["head_dist.weight"].shape == (
        4, 32)


def test_registry_matches_jax():
    assert list_models() == jreg.list_models()
    for table in ("VIT_CONFIGS", "BERT_CONFIGS"):
        ours, ref = getattr(treg, table), getattr(jreg, table)
        assert sorted(ours) == sorted(ref)
        for name in ref:
            assert (dataclasses.asdict(ours[name])
                    == dataclasses.asdict(ref[name])), name


def test_create_model(tmp_path):
    cfg, sd = create_model("deit_base_distilled_patch16_224", seed=3,
                           device="cpu", depth=1, num_classes=5)
    assert cfg == ViTConfig(distilled=True, depth=1, num_classes=5)
    assert sd["head_dist.weight"].shape == (5, 768)
    assert "blocks.1.norm1.weight" not in sd
    _, again = create_model("deit_base_distilled_patch16_224", seed=3,
                            device="cpu", depth=1, num_classes=5)
    _assert_same(again, sd)
    bcfg, bsd = create_model("bert-base-uncased", device="cpu", **BERT)
    assert bcfg == BertConfig(**BERT) and "classifier.weight" in bsd
    jcfg, params = _jax_vit(TINY)
    path = _save_pth(tmp_path / "vit.pth",
                     jconv.vit_state_dict_from_params(params, jcfg), "model")
    cfg, sd = create_model("vit_base_patch16_224", checkpoint=path,
                           device="cpu", **TINY)
    _assert_same(sd, tconv.vit_params_from_jax(_np_tree(params),
                                               ViTConfig(**TINY)))
    with pytest.raises(ValueError, match="unknown model"):
        create_model("resnet50", device="cpu")


def test_create_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("vit_base_patch16_224", depth=1)
