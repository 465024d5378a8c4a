"""The port's weight converter against the JAX package's state-dict export."""

import jax
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.params.convert import (
    vit_state_dict_from_params)
from transformer_explainability_torch.models.vit import (
    ViTConfig, VisionTransformer)
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

SMALL = dict(img_size=32, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_vit_params_from_jax_matches_state_dict_export(qkv_bias):
    jcfg = jvit.ViTConfig(qkv_bias=qkv_bias, **SMALL)
    cfg = ViTConfig(qkv_bias=qkv_bias, **SMALL)
    tree = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    tree_np = jax.tree.map(np.asarray, tree)
    sd = vit_params_from_jax(tree_np, cfg)
    want = vit_state_dict_from_params(tree, jcfg)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].dtype == torch.float32, k
        np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)

    model = VisionTransformer(cfg, dtype=torch.float32)
    model.load_state_dict(sd)                      # strict: every key fits
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_init_params_layout_and_statistics():
    """The port's own seeded init fills the same keys with the JAX init's
    distributions: trunc-normal(0.02) cut at ±2σ, zero biases, unit LN."""
    from transformer_explainability_torch.models.vit import init_params
    cfg = ViTConfig(**SMALL)
    gen = torch.Generator().manual_seed(0)
    sd = init_params(cfg, generator=gen, device="cpu")
    want = vit_state_dict_from_params(
        jvit.init_params(jax.random.PRNGKey(0), jvit.ViTConfig(**SMALL)),
        jvit.ViTConfig(**SMALL))
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert tuple(v.shape) == want[k].shape, k
    w = sd["blocks.0.mlp.fc1.weight"]
    assert w.abs().max() <= 0.04 and 0.015 < w.std() < 0.02
    assert torch.equal(sd["blocks.1.norm2.weight"], torch.ones(24))
    assert torch.equal(sd["head.bias"], torch.zeros(10))
    again = init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
