"""The |W| planes the rule products read, made once per model.

The GEMM core (``csrc/gemm.cuh``) reads its B operand from shared memory
into the tensor cores, so it cannot form ``|W|`` on the fly as the Ampere
core did in registers: every prepared weight carries the split of ``|w|``,
``(|hi|, sign(hi)·lo)``, made once beside its own split
(``precision.PreparedWeight.abs``). Each weight a rule reads, in each mode
the models prepare, must carry exactly ``precision.kabs`` of its split, bit
for bit, and that must be JAX's ``_kabs`` of the same planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_torch.models.bert import (
    BertConfig, BertForSequenceClassification)
from transformer_explainability_torch.models.vit import (
    ViTConfig, VisionTransformer)
from transformer_explainability_torch.ops import precision as P
from transformer_explainability_torch.parallel.tensor import tp_shard

MODES = ["bfloat16", "tensorfloat32"]
VIT = dict(img_size=32, patch_size=16, embed_dim=24, depth=2, num_heads=4,
           num_classes=10)
BERT = dict(vocab_size=97, hidden_size=24, num_layers=2, num_heads=4,
            intermediate_size=40, max_position_embeddings=64, num_labels=3)


def _bits(t):
    return t.view(torch.int16)


def _assert_abs_planes(w, mode):
    """``w.abs`` is kabs of ``w``'s own planes, bitwise, and JAX's _kabs."""
    assert isinstance(w, P.PreparedWeight)
    assert len(w) == (2 if mode == "tensorfloat32" else 1)
    want = P.kabs(tuple(w))
    assert len(w.abs) == len(want)
    for got, ref in zip(w.abs, want):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(_bits(got), _bits(ref))
    jplanes = tuple(
        jnp.asarray(t.detach().float().numpy()).astype(jnp.bfloat16)
        for t in w)
    jabs = pk._kabs(jplanes if len(jplanes) > 1 else jplanes[0])
    jabs = jabs if isinstance(jabs, tuple) else (jabs,)
    for got, ref in zip(w.abs, jabs):
        np.testing.assert_array_equal(_bits(got.detach()).numpy(),
                                      np.asarray(ref).view(np.int16))


@pytest.mark.parametrize("mode", MODES)
def test_prepare_weight_makes_the_abs_planes(mode):
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(24, 40))
    # signed zeros and values whose lo flips sign with hi
    w[0, :4] = torch.tensor([0.0, -0.0, -1.0 - 2 ** -12, 1.0 + 2 ** -12])
    _assert_abs_planes(P.prepare_weight(w, mode), mode)


@pytest.mark.parametrize("mode", MODES)
def test_vit_block_params_carry_abs_planes(mode):
    torch.manual_seed(0)
    model = VisionTransformer(ViTConfig(**VIT), dtype=torch.float64)
    for i in range(model.cfg.depth):
        for w in model.block_params(i, mode)[8:]:
            _assert_abs_planes(w, mode)


@pytest.mark.parametrize("mode", MODES)
def test_bert_layer_params_carry_abs_planes(mode):
    torch.manual_seed(1)
    model = BertForSequenceClassification(BertConfig(**BERT),
                                          dtype=torch.float64)
    for i in range(model.cfg.num_layers):
        for w in model.layer_params(i, mode)[8:]:
            _assert_abs_planes(w, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1, 2])
def test_tp_shards_carry_abs_planes(mode, k):
    torch.manual_seed(2)
    cfg = ViTConfig(**VIT)
    sd = {n: t.detach() for n, t in
          VisionTransformer(cfg, dtype=torch.float64).state_dict().items()}
    for rank in range(k):
        for blk in tp_shard(sd, cfg, k, rank, mode).blocks:
            for w in blk[8:]:
                _assert_abs_planes(w, mode)


def test_kabs_returns_the_prepared_planes():
    w = P.prepare_weight(torch.randn(16, 8, dtype=torch.float64),
                         "tensorfloat32")
    assert P.kabs(w) is w.abs
