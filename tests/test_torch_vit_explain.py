"""The port's ViT ``transformer_attribution`` slice against the JAX package.

Same weights both ways (JAX ``init_params`` exported with the port's
converter), same inputs (numpy, from a seed), float64 on the CPU, where the
port's kernel wrappers take their plain versions and the JAX package its jnp
paths with the kernel-structured reverse (``use_attn_kernel=True``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain.generator import explain_single
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_torch import Explainer
from transformer_explainability_torch.explain.generator import (
    explain_batch, make_explain_fn)
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

SMALL = dict(img_size=32, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _jax_heat(jcfg, params, img, index, start_layer):
    fn = jax.jit(lambda p, x, i: explain_single(
        p, x, i, jcfg, start_layer=start_layer, use_attn_kernel=True))
    return np.asarray(fn(params, jnp.asarray(img), jnp.int32(index)))


@pytest.mark.parametrize("start_layer", [0, 1])
def test_small_config_matches_jax_f64(x64, start_layer):
    jcfg, params, sd = _weights(SMALL)
    rng = np.random.RandomState(0)
    imgs = rng.randn(4, 3, 32, 32)
    idx = np.array([3, -1, 7, -1])
    ex = Explainer(sd, ViTConfig(**SMALL), device="cpu")
    got = ex.explain(imgs, idx, start_layer=start_layer).numpy()
    assert got.shape == (4, 4) and got.dtype == np.float64
    for i in range(4):
        want = _jax_heat(jcfg, params, imgs[i], idx[i], start_layer)
        np.testing.assert_allclose(got[i], want, rtol=1e-8, atol=1e-12,
                                   err_msg=f"sample {i}")


def test_batched_equals_per_sample():
    """The port's counterpart of the JAX package's batched-vs-loop check:
    a batch gives each sample what it gets alone."""
    _, _, sd = _weights(SMALL, key=1)
    sd32 = {k: v.float() for k, v in sd.items()}
    ex = Explainer(sd32, ViTConfig(**SMALL), device="cpu")
    rng = np.random.RandomState(1)
    imgs = rng.randn(5, 3, 32, 32).astype(np.float32)
    idx = np.array([-1, 2, 9, -1, 0])
    batched = ex.explain(imgs, idx)
    for i in range(5):
        alone = ex.explain(imgs[i], idx[i:i + 1])
        torch.testing.assert_close(batched[i:i + 1], alone, rtol=1e-5,
                                   atol=1e-7)
    # index -1 is the argmax class
    logits = ex.model(torch.from_numpy(imgs))
    explicit = ex.explain(imgs, logits.argmax(-1))
    torch.testing.assert_close(ex.explain(imgs), explicit, rtol=0, atol=0)


def test_full_width_two_blocks_matches_jax_f64(x64):
    """ViT-B widths (D=768, h=12, n=197: the ragged token count and the real
    head width) at depth 2, one image."""
    fields = dict(depth=2)
    jcfg, params, sd = _weights(fields)
    rng = np.random.RandomState(2)
    img = rng.randn(1, 3, 224, 224)
    ex = Explainer(sd, ViTConfig(**fields), device="cpu")
    got = ex.explain(img, [17]).numpy()
    want = _jax_heat(jcfg, params, img[0], 17, 0)
    assert got.shape == (1, 196)
    np.testing.assert_allclose(got[0], want, rtol=1e-8, atol=1e-12)


def test_unported_options_raise():
    _, _, sd = _weights(SMALL)
    cfg = ViTConfig(**SMALL)
    ex = Explainer(sd, cfg, device="cpu")
    img = np.zeros((1, 3, 32, 32))
    with pytest.raises(ValueError):
        ex.explain(img, method="nonsense")
    # what raised until the kernels had bf16×3 instances (ROADMAP A3b)
    # runs: the tf32 split arm, raw tensorfloat32 on the kernel branch and
    # a tensorfloat32 island on the float32 base's kernels (held to JAX in
    # tests/test_torch_vit_tf32.py and test_torch_vit_presets.py)
    for kw in (dict(matmul_precision="tensorfloat32",
                    relprop_precision="bfloat16", attn_precision="float32",
                    block_kernel=False),
               dict(matmul_precision="tensorfloat32"),
               dict(attn_precision="tensorfloat32")):
        heat = Explainer(sd, cfg, device="cpu", **kw).explain(img + 0.5)
        assert heat.shape == (1, 4) and torch.isfinite(heat).all()
    # the diagnostics are defined for the fused method only, as in JAX
    with pytest.raises(ValueError, match="transformer_attribution"):
        make_explain_fn(cfg, "cpu", method="rollout", with_diagnostics=True)


def test_uint8_preprocess_matches_float_input():
    _, _, sd = _weights(SMALL)
    cfg = ViTConfig(**SMALL)
    sd32 = {k: v.float() for k, v in sd.items()}
    from transformer_explainability_torch.models.vit import VisionTransformer
    model = VisionTransformer(cfg, dtype=torch.float32)
    model.load_state_dict(sd32)
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    idx = np.array([1, -1])
    a = make_explain_fn(cfg, "cpu", preprocess="uint8")(model, frames, idx)
    x = ((frames.astype(np.float32) / 255.0 - 0.5) / 0.5).transpose(0, 3, 1, 2)
    b = explain_batch(model, torch.from_numpy(x), torch.from_numpy(idx))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.slow
def test_full_vit_b_matches_fidelity_truth():
    """Full 12-block ViT-B/16 in float64 against the committed f64 truth
    (experiments/data/fidelity_truth.npz, weights JAX init_params(PRNGKey(0)))
    on the catdog row (index 16) and one randn row, at rel-L2 1e-8. The
    catdog row is ill-conditioned: summation order alone moves it by ~1e-8
    (the JAX package's own float64 path, einsum or kernel-structured,
    measured 4.57e-8 from this truth with jax 0.9.0 on a CPU; the randn row
    1.2e-13), so that row is held to 1e-7."""
    data = np.load(os.path.join(REPO, "experiments/data/fidelity_truth.npz"))
    _, _, sd = _weights({})
    ex = Explainer(sd, ViTConfig(), device="cpu")
    for row, bound in ((16, 1e-7), (0, 1e-8)):
        got = ex.explain(data["imgs"][row:row + 1].astype(np.float64),
                         data["idx"][row:row + 1]).numpy()[0]
        want = data["truth"][row]
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= bound, (row, rel)
