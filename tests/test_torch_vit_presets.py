"""The port's ``production`` and ``bfloat16`` presets (the block megakernel
path) against the JAX package.

Same weights both ways (JAX ``init_params`` exported with the port's
converter), same inputs (numpy, from a seed), float64 on the CPU, where the
port's kernel wrappers take their plain versions and the JAX package its
jnp megakernel paths (``use_attn_kernel=True`` with the preset). The bf16
roundings of both are reproduced bit for bit, so only the summation order
of float64 differs: rtol 1e-8, atol 1e-12, as for the float32 preset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain.generator import (
    PRECISION_PRESETS as JAX_PRESETS, explain_single,
    precision_kwargs as jax_precision_kwargs)
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_torch import Explainer
from transformer_explainability_torch.explain.generator import (
    PRECISION_PRESETS, check_precision, explain_batch, precision_kwargs)
from transformer_explainability_torch.models.vit import (
    ViTConfig, VisionTransformer, init_params)
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

SMALL = dict(img_size=32, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)
TF32 = "tensorfloat32"
# the presets, raw tensorfloat32 (precision_kwargs) and the bfloat16 base
# with a tensorfloat32 attention island: each takes the block megakernels
PRESETS = ["production", "bfloat16", "tensorfloat32", "bf16-tf32-attn"]
ISLANDS = {"bf16-tf32-attn": dict(matmul_precision="bfloat16",
                                  attn_precision="tensorfloat32")}


def _kwargs(preset):
    return dict(ISLANDS[preset]) if preset in ISLANDS else precision_kwargs(
        preset)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _weights(fields, key=0):
    """(JAX f64 pytree, port f64 state dict) of the same init."""
    jcfg = jvit.ViTConfig(**fields)
    tree = jax.tree.map(np.asarray,
                        jvit.init_params(jax.random.PRNGKey(key), jcfg))
    tree64 = jax.tree.map(lambda a: a.astype(np.float64), tree)
    sd = vit_params_from_jax(tree64, ViTConfig(**fields))
    return jcfg, jax.tree.map(jnp.asarray, tree64), sd


def _jax_heat(jcfg, params, img, index, preset):
    kw = (ISLANDS[preset] if preset in ISLANDS
          else jax_precision_kwargs(preset))
    fn = jax.jit(lambda p, x, i: explain_single(
        p, x, i, jcfg, use_attn_kernel=True, **kw))
    return np.asarray(fn(params, jnp.asarray(img), jnp.int32(index)))


def test_presets_match_the_jax_package():
    assert PRECISION_PRESETS == JAX_PRESETS
    for p in list(JAX_PRESETS) + ["tensorfloat32"]:
        assert precision_kwargs(p) == jax_precision_kwargs(p)
    with pytest.raises(ValueError):
        precision_kwargs("fp8")


@pytest.mark.parametrize("preset", PRESETS)
def test_small_config_preset_matches_jax_f64(x64, preset):
    jcfg, params, sd = _weights(SMALL)
    rng = np.random.RandomState(0)
    imgs = rng.randn(3, 3, 32, 32)
    idx = np.array([3, -1, 7])
    ex = Explainer(sd, ViTConfig(**SMALL), device="cpu", **_kwargs(preset))
    got = ex.explain(imgs, idx).numpy()
    assert got.shape == (3, 4) and got.dtype == np.float64
    for i in range(3):
        want = _jax_heat(jcfg, params, imgs[i], idx[i], preset)
        np.testing.assert_allclose(got[i], want, rtol=1e-8, atol=1e-12,
                                   err_msg=f"sample {i}")


@pytest.mark.parametrize("preset", PRESETS)
def test_full_width_two_blocks_preset_matches_jax_f64(x64, preset):
    """ViT-B widths (D=768, h=12, n=197, M=3072) at depth 2, one image."""
    fields = dict(depth=2)
    jcfg, params, sd = _weights(fields)
    img = np.random.RandomState(2).randn(1, 3, 224, 224)
    ex = Explainer(sd, ViTConfig(**fields), device="cpu", **_kwargs(preset))
    got = ex.explain(img, [17]).numpy()
    want = _jax_heat(jcfg, params, img[0], 17, preset)
    assert got.shape == (1, 196)
    np.testing.assert_allclose(got[0], want, rtol=1e-8, atol=1e-12)


def test_production_batched_equals_per_sample():
    """A batch gives each sample what it gets alone (float64: the
    megakernels' add rules sum per sample)."""
    _, _, sd = _weights(SMALL, key=1)
    ex = Explainer(sd, ViTConfig(**SMALL), device="cpu",
                   **precision_kwargs("production"))
    imgs = np.random.RandomState(1).randn(5, 3, 32, 32)
    idx = np.array([-1, 2, 9, -1, 0])
    batched = ex.explain(imgs, idx)
    for i in range(5):
        alone = ex.explain(imgs[i], idx[i:i + 1])
        torch.testing.assert_close(batched[i:i + 1], alone, rtol=1e-9,
                                   atol=1e-12)


def test_production_takes_the_block_kernels_and_prepares_once():
    """The preset runs block_fwd_core / block_rev_core (plain on the CPU,
    called through the ops table) and splits each weight once."""
    cfg = ViTConfig(**SMALL)
    model = VisionTransformer(cfg, dtype=torch.float32)
    model.load_state_dict(init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    calls = {"block_fwd_core": 0, "block_rev_core": 0}

    def counted(name, f):
        def g(*a, **k):
            calls[name] += 1
            return f(*a, **k)
        return g

    ops = K.PLAIN_OPS._replace(
        block_fwd_core=counted("block_fwd_core", K.block_fwd_core_plain),
        block_rev_core=counted("block_rev_core", K.block_rev_core_plain),
        attn_fwd_core=None, attn_rev_core=None)
    imgs = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    idx = torch.tensor([-1, 1])
    a = explain_batch(model, imgs, idx, ops=ops,
                      **precision_kwargs("production"))
    assert calls == {"block_fwd_core": cfg.depth, "block_rev_core": cfg.depth}
    w0 = model.block_params(0, "tensorfloat32").wqkv
    assert model.block_params(0, "tensorfloat32").wqkv[0] is w0[0]
    b = explain_batch(model, imgs, idx, **precision_kwargs("production"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        model.blocks[0].attn.qkv.weight.mul_(2.0)   # in place: split again
    assert model.block_params(0, "tensorfloat32").wqkv[0] is not w0[0]


@pytest.mark.parametrize("kw,raises", [
    # raw tensorfloat32 and a tensorfloat32 attention island on the
    # bfloat16 base: the megakernels' bf16×3 instances (they raised until
    # ROADMAP A3b)
    (dict(matmul_precision="tensorfloat32"), None),
    # islands above the base: the non-kernel branch, no kernel mode asked
    (dict(matmul_precision="bfloat16", relprop_precision="float32"), None),
    (dict(matmul_precision="bfloat16", mlp_precision="tensorfloat32"),
     None),
    (dict(matmul_precision="bfloat16", attn_precision="tensorfloat32"),
     None),
    # the float32 base's kernel branch runs its MLP at the base
    (dict(matmul_precision="float32", mlp_precision="bfloat16"), None),
    (dict(matmul_precision="float16"), ValueError),
    (dict(matmul_precision="bfloat16", attn_precision="half"), ValueError),
    (dict(matmul_precision="tensorfloat32", relprop_precision="bfloat16"),
     None),                                 # attention follows the base
    (dict(matmul_precision="tensorfloat32", relprop_precision="bfloat16",
          attn_precision="float32"), None),
    (dict(matmul_precision="tensorfloat32", relprop_precision="bfloat16",
          attn_precision="bfloat16", mlp_precision="tensorfloat32"), None),
    (dict(matmul_precision="bfloat16", attn_precision="float32"), None),
    # the BERT layer kernels and the tensor-parallel program have no bf16×3
    # attention or rule instance yet
    (dict(matmul_precision="tensorfloat32", family="bert"),
     NotImplementedError),
    (dict(matmul_precision="bfloat16", attn_precision="tensorfloat32",
          family="bert"), NotImplementedError),
    (dict(matmul_precision="tensorfloat32", relprop_precision="bfloat16",
          attn_precision="float32", family="bert"), None),
    (dict(matmul_precision="tensorfloat32", family="tp"),
     NotImplementedError),
])
def test_precision_gates(kw, raises):
    """Each configuration's gate; a ViT configuration that passes runs on
    the kernel branch (one sample on the CPU, finite)."""
    if raises is None:
        check_precision(**kw)
        if kw.get("family", "vit") == "vit":
            _, _, sd = _weights(SMALL)
            heat = Explainer(sd, ViTConfig(**SMALL), device="cpu",
                             **kw).explain(np.ones((1, 3, 32, 32)))
            assert heat.shape == (1, 4) and torch.isfinite(heat).all()
    else:
        family = kw.get("family", "").upper()
        with pytest.raises(raises, match=(
                rf"ROADMAP B, raw tensorfloat32 \({family}\)"
                if raises is NotImplementedError else None)):
            check_precision(**kw)


def test_bert_and_tp_refuse_raw_tensorfloat32():
    """BERT at raw tensorfloat32 (its layer kernels) and the tensor-parallel
    program at raw tensorfloat32 raise at their entry points, naming their
    ROADMAP B items; the BERT wrappers refuse a bf16×3 attention or rule
    flag before any C entry sees it."""
    from transformer_explainability_torch.explain import BertExplainer
    from transformer_explainability_torch.models import bert as tbert
    from transformer_explainability_torch.parallel.tensor import (
        make_tp_explain_fn)
    bcfg = tbert.BertConfig(vocab_size=50, hidden_size=16, num_layers=2,
                            num_heads=2, intermediate_size=32,
                            max_position_embeddings=16, num_labels=2)
    bp = tbert.init_params(bcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    bex = BertExplainer(bp, bcfg, device="cpu",
                        **precision_kwargs("tensorfloat32"))
    ids = np.array([[1, 5, 6, 7, 2, 0]])
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP B, raw tensorfloat32 \(BERT\)"):
        bex.explain(ids, np.ones_like(ids))
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP B, raw tensorfloat32 \(TP\)"):
        make_tp_explain_fn(ViTConfig(**SMALL), group=None, device="cpu",
                           **precision_kwargs("tensorfloat32"))
    p = [None] * 8 + [(torch.zeros(8, 8, dtype=torch.bfloat16),) * 2] * 4
    for name, modes in (("bert_layer_fwd_core", dict(attn_mode=TF32)),
                        ("bert_out_rev_core", dict(rule=TF32)),
                        ("bert_attn_rev_core", dict(attn_mode="bfloat16",
                                                    rule_mode=TF32))):
        with pytest.raises(NotImplementedError,
                           match=r"raw tensorfloat32 \(BERT\)"):
            K._bert_modes(name, p, **modes)
