"""The ViT kernel branch's tensorfloat32 (bf16×3) paths that run the
attention kernels B4 and B5, against the JAX package on the CPU: the tf32
split arm (JAX's ``TE_TPU_NO_BLOCK_KERNEL=1``: the module attribute
``models.vit._NO_BLOCK_KERNEL`` set in this process; the port's
``block_kernel=False``) and the float32 base's tensorfloat32 islands.

* **Structure**, float64: the port with every product outside the kernels
  exact (``torch_precision_oracle.rounding_off``), B4 and B5 in their
  bf16×3 modes by ``kdot``, against JAX's float64 program with its B4 and
  B5 in Pallas interpret mode (which rounds in their modes; JAX on the CPU
  computes its XLA products exactly at any precision): rtol 1e-8, atol
  1e-12. A spy on the ops table shows B4 and B5 called once a block in the
  expected modes, and no B6 on the split arm.
* **Per product**: the port's products outside the kernels, the split
  arm's plain MLP arm among them, against JAX's lowered program, each
  product's operand shapes and precision (``torch_precision_oracle``), on
  a config whose product sites have distinct shapes; JAX's B4 and B5 are
  stubbed there and B1 is pinned to HIGHEST, as its TPU runs them
  (``jax_tpu_lowering``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain import generator as jgen
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_torch import Explainer
from transformer_explainability_torch.explain.generator import explain_batch
from transformer_explainability_torch.models.vit import (
    ViTConfig, VisionTransformer)
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

from torch_precision_oracle import (
    assert_same_products, jax_products, port_products, rounding_off)
# the per-product comparison's JAX program, as test_torch_vit_precisions
# lowers it
from test_torch_vit_precisions import jax_tpu_lowering  # noqa: F401

TF32 = "tensorfloat32"
SMALL = dict(img_size=32, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)
# distinct product shapes: n = 5 tokens, D = 32, 2 heads of 16, M = 128
TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            num_classes=10)
# (port / JAX keyword arguments, the JAX split arm?, B4's mode, B5's
# (attention, rule) modes)
PATHS = {
    "split-arm": (dict(matmul_precision=TF32, block_kernel=False), True,
                  TF32, (TF32, TF32)),
    "split-arm-islands": (dict(matmul_precision=TF32,
                               relprop_precision="bfloat16",
                               attn_precision="float32",
                               block_kernel=False), True,
                          "float32", ("float32", "bfloat16")),
    "f32-base-tf32-attn": (dict(attn_precision=TF32), False, TF32,
                           (TF32, "float32")),
    "f32-base-tf32-rules": (dict(relprop_precision=TF32), False, "float32",
                            ("float32", TF32)),
    "f32-base-tf32-attn-bf16-rules": (dict(attn_precision=TF32,
                                           relprop_precision="bfloat16"),
                                      False, TF32, (TF32, "bfloat16")),
}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """JAX's B4 and B5 in Pallas interpret mode, which rounds in their
    modes as the TPU does (their CPU fallback computes exactly)."""
    for name in ("attn_fwd_core", "attn_rev_core"):
        fn = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda *a, _fn=fn, **kw: _fn(
            *a, **kw, interpret=True))


def _weights(fields, dtype=np.float64):
    jcfg = jvit.ViTConfig(**fields)
    tree = jax.tree.map(lambda a: np.asarray(a).astype(dtype),
                        jvit.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), vit_params_from_jax(
        tree, ViTConfig(**fields))


def _jax_kw(kw):
    return {k: v for k, v in kw.items() if k != "block_kernel"}


def _spy_ops(calls):
    """The plain ops table with B4, B5 and B6 recording their modes."""
    def spy(name, f, *keys):
        def g(*a, **kw):
            calls.append((name, tuple(kw[k] for k in keys)))
            return f(*a, **kw)
        return g

    return K.PLAIN_OPS._replace(
        attn_fwd_core=spy("B4", K.attn_fwd_core_plain, "mxu"),
        attn_rev_core=spy("B5", K.attn_rev_core_plain, "attn_mxu",
                          "rule_mxu"),
        mlp_rev_core=spy("B6", K.mlp_rev_core_plain),
        block_fwd_core=None, block_rev_core=None)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tf32_path_matches_jax_f64(x64, jax_kernels_interpreted, monkeypatch,
                                   path):
    kw, split_arm, b4, b5 = PATHS[path]
    monkeypatch.setattr(jvit, "_NO_BLOCK_KERNEL", split_arm)
    jcfg, params, sd = _weights(SMALL)
    imgs = np.random.RandomState(3).randn(2, 3, 32, 32)
    idx = np.array([3, -1])
    fn = jax.jit(jax.vmap(lambda p, x, i: jgen.explain_single(
        p, x, i, jcfg, use_attn_kernel=True, **_jax_kw(kw)),
        in_axes=(None, 0, 0)))
    want = np.asarray(fn(params, jnp.asarray(imgs),
                         jnp.asarray(idx, jnp.int32)))
    cfg = ViTConfig(**SMALL)
    model = VisionTransformer(cfg, dtype=torch.float64)
    model.load_state_dict(sd)
    calls = []
    with rounding_off():
        got = explain_batch(model, torch.from_numpy(imgs),
                            torch.from_numpy(idx), ops=_spy_ops(calls), **kw)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)
    assert calls == [("B4", (b4,))] * cfg.depth + [("B5", b5)] * cfg.depth


@pytest.mark.parametrize("path", ["split-arm", "split-arm-islands"])
def test_split_arm_products_follow_jax_lowered_program(jax_tpu_lowering,
                                                       monkeypatch, path):
    """The tf32 split arm's products outside B4 and B5 (the qkv, proj and
    MLP products of ``step_lite`` and ``kstep``, the plain MLP arm's rule
    products) in the modes of JAX's lowered program: bf16×3 at the base,
    the rule island's mode for the rules."""
    kw, split_arm, _, _ = PATHS[path]
    monkeypatch.setattr(jvit, "_NO_BLOCK_KERNEL", split_arm)
    jcfg, params, sd = _weights(TINY, np.float32)
    img = np.random.RandomState(1).randn(1, 3, 32, 32).astype(np.float32)
    lowered = jax_products(
        lambda p, x, i: jgen.explain_single(p, x, i, jcfg,
                                            use_attn_kernel=True,
                                            **_jax_kw(kw)),
        params, jnp.asarray(img[0]), jnp.int32(3))
    ex = Explainer(sd, ViTConfig(**TINY), "cpu", **kw)
    with port_products() as seen:
        heat = ex.explain(img, [3])
    assert heat.shape == (1, 4)
    # the head's product and the class gradient's seed: the port's kernel
    # branch keeps both exact at every base (ROADMAP A3a; JAX runs them at
    # the base), so they are compared apart
    D, C = TINY["embed_dim"], TINY["num_classes"]
    head = {(1, D, (1, C)), (1, C, (1, D))}
    assert {p for p in seen if p[0] in head} == {(k, "float32")
                                                 for k in head}
    assert_same_products({p for p in seen if p[0] not in head},
                         {p for p in lowered if p[0] not in head})
    assert TF32 in {m for _, m in seen}


def test_tf32_split_arm_batch_equals_samples():
    """A batch of the tf32 split arm gives each sample what it gets alone
    (float64)."""
    _, _, sd = _weights(SMALL)
    ex = Explainer(sd, ViTConfig(**SMALL), "cpu",
                   **PATHS["split-arm"][0])
    imgs = np.random.RandomState(4).randn(3, 3, 32, 32)
    idx = np.array([-1, 2, 9])
    batched = ex.explain(imgs, idx)
    for i in range(3):
        torch.testing.assert_close(batched[i:i + 1],
                                   ex.explain(imgs[i], idx[i:i + 1]),
                                   rtol=1e-9, atol=1e-12)
