"""The ViT split path and its MLP reverse kernel B6 against their references,
on the CPU.

B6's plain version (``kernels.mlp_rev_core_plain``) against the JAX Pallas
kernel ``mlp_rev_core`` in interpret mode (float64, x64 on, numpy-seeded
inputs) in the four product-mode pairs, at a small ragged shape and at
ViT-B width, and in float32 mode against the JAX jnp form. The split path
(``block_kernel=False`` at the ``bfloat16`` base: B4, B5 and B6 with the
products outside them in bf16) against the port's megakernel path at the
same preset (float64, rtol 1e-8): both compute the same function with the
same bf16 roundings, and the megakernel path is held to JAX in
``tests/test_torch_vit_presets.py``. Then which kernels the split path
takes, and its gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_torch import Explainer
from transformer_explainability_torch.explain.generator import (
    check_precision, explain_batch, precision_kwargs)
from transformer_explainability_torch.models import vit as tvit
from transformer_explainability_torch.models.vit import (
    ViTConfig, VisionTransformer)
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as P
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

EPS = 1e-6
SMALL = dict(img_size=32, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)
# (mxu, rule_mxu) of B6
MODES = [("bfloat16", "bfloat16"), ("tensorfloat32", "bfloat16"),
         ("tensorfloat32", "tensorfloat32"), ("float32", "float32")]


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _arrays(seed, b, n, D, M):
    rng = np.random.RandomState(seed)
    return dict(x_mid=rng.randn(b, n, D) + 0.3, g_out=rng.randn(b, n, D),
                R=rng.randn(b, n, D), s=1 + 0.1 * rng.randn(D),
                b=0.1 * rng.randn(D), w1=rng.randn(D, M) / np.sqrt(D),
                w2=rng.randn(M, D) / np.sqrt(M), b1=0.1 * rng.randn(M),
                b2=0.1 * rng.randn(D))


def _port_params(a, mode):
    """The JAX kernel-layout weights as a BlockParams of the port: the
    nn.Linear layout, prepared for ``mode`` (kept as tensors for float32);
    the attention entries are not read by B6."""
    t = torch.from_numpy

    def weight(w):
        w = t(np.ascontiguousarray(w.T))
        return w if mode == "float32" else P.prepare_weight(w, mode)

    z = torch.zeros(1, dtype=torch.float64)
    return bm.BlockParams(z, z, t(a["s"]), t(a["b"]), z, z, t(a["b1"]),
                          t(a["b2"]), None, None, weight(a["w1"]),
                          weight(a["w2"]))


def _jax_params(a):
    return ({"scale": jnp.asarray(a["s"]), "bias": jnp.asarray(a["b"])},
            {"fc1": {"kernel": jnp.asarray(a["w1"]),
                     "bias": jnp.asarray(a["b1"])},
             "fc2": {"kernel": jnp.asarray(a["w2"]),
                     "bias": jnp.asarray(a["b2"])}})


def _check_b6(a, mxu, rule, jax_fn):
    got = K.mlp_rev_core(*(torch.from_numpy(a[k])
                           for k in ("x_mid", "g_out", "R")),
                         _port_params(a, mxu), EPS, mxu, rule)
    ln, bp = _jax_params(a)
    for i in range(a["x_mid"].shape[0]):
        want = jax_fn(*(jnp.asarray(a[k][i]) for k in ("x_mid", "g_out", "R")),
                      ln, bp)
        for name, g, w in zip(["g_mid", "Rm"], got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=1e-9, atol=1e-12,
                                       err_msg=f"{name}, sample {i}")


@pytest.mark.parametrize("modes", MODES)
def test_mlp_rev_core_plain_matches_jax_interpret(x64, modes):
    mxu, rule = modes
    _check_b6(_arrays(0, 3, 23, 16, 40), mxu, rule,
              lambda x, g, R, ln, bp: pk.mlp_rev_core(
                  x, g, R, ln, bp, EPS, mxu=mxu, rule_mxu=rule,
                  use_pallas=True, interpret=True))


def test_mlp_rev_core_plain_matches_jax_interpret_vit_b_width(x64):
    """One sample at ViT-B's widths (n=197, D=768, M=3072), production's
    MLP modes."""
    _check_b6(_arrays(1, 1, 197, 768, 3072), "tensorfloat32", "bfloat16",
              lambda x, g, R, ln, bp: pk.mlp_rev_core(
                  x, g, R, ln, bp, EPS, mxu="tensorfloat32",
                  rule_mxu="bfloat16", use_pallas=True, interpret=True))


def test_mlp_rev_core_float32_matches_jax_jnp(x64):
    _check_b6(_arrays(2, 3, 23, 16, 40), "float32", "float32",
              lambda x, g, R, ln, bp: pk._mlp_rev_core_jnp(
                  x, g, R, ln, bp, EPS, "ours", 1.0))


def test_mlp_rev_core_wrapper_takes_plain_path_on_cpu():
    a = _arrays(3, 2, 9, 16, 40)
    args = [torch.from_numpy(a[k]) for k in ("x_mid", "g_out", "R")]
    p = _port_params(a, "bfloat16")
    before = K.launch_counts()
    for g, w in zip(K.mlp_rev_core(*args, p, EPS),
                    K.mlp_rev_core_plain(*args, p, EPS)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert K.launch_counts() == before      # no kernel launched on the CPU
    with pytest.raises(ValueError):
        K.mlp_rev_core(args[0], args[1][:, :-1].contiguous(), args[2], p, EPS)
    with pytest.raises(ValueError):
        K.mlp_rev_core(args[0][0], args[1][0], args[2][0], p, EPS)
    with pytest.raises(TypeError):
        K.mlp_rev_core(args[0].half(), *args[1:], p, EPS)
    with pytest.raises(ValueError):               # W1 in the wrong layout
        K.mlp_rev_core(*args, p._replace(w1=P.transpose(p.w1)), EPS)


# ---------------------------------------------------------------------------
# The split path against the megakernel path
# ---------------------------------------------------------------------------

def _weights(fields, key=0):
    """The port's f64 state dict of JAX ``init_params``."""
    jcfg = jvit.ViTConfig(**fields)
    tree = jax.tree.map(lambda x: np.asarray(x).astype(np.float64),
                        jvit.init_params(jax.random.PRNGKey(key), jcfg))
    return vit_params_from_jax(tree, ViTConfig(**fields))


@pytest.mark.parametrize("fields,n_img", [(SMALL, 3), (dict(depth=2), 1)])
def test_split_path_matches_megakernel_path(fields, n_img):
    """SMALL: three images with argmax indices; ViT-B widths at depth 2:
    one image."""
    cfg = ViTConfig(**fields)
    sd = _weights(fields)
    rng = np.random.RandomState(4)
    imgs = rng.randn(n_img, 3, cfg.img_size, cfg.img_size)
    idx = np.array([3, -1, -1][:n_img])
    bf16 = precision_kwargs("bfloat16")
    want = Explainer(sd, cfg, "cpu", **bf16).explain(imgs, idx)
    got = Explainer(sd, cfg, "cpu", block_kernel=False, **bf16).explain(
        imgs, idx)
    assert got.shape == (n_img, cfg.num_patches) and got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-8, atol=1e-12)


def _counting_ops():
    calls = {}

    def counted(name, f):
        def g(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return f(*a, **k)
        return g

    return calls, K.AttnOps(*(counted(n, f)
                              for n, f in K.PLAIN_OPS._asdict().items()))


@pytest.mark.parametrize("attn_precision", [None, "float32"])
def test_split_path_takes_b4_b5_b6(attn_precision):
    cfg = ViTConfig(**SMALL)
    model = VisionTransformer(cfg, dtype=torch.float64)
    model.load_state_dict(_weights(SMALL, key=1))
    calls, ops = _counting_ops()
    imgs = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 32, 32))
    out = explain_batch(model, imgs, torch.tensor([-1, 1]), ops=ops,
                        block_kernel=False, matmul_precision="bfloat16",
                        attn_precision=attn_precision)
    L = cfg.depth
    assert calls == {"attn_fwd_core": L, "attn_rev_core": L,
                     "mlp_rev_core": L, "rollout_from_grad_cam": 1}
    assert out.shape == (2, cfg.num_patches) and torch.isfinite(out).all()
    # the block kernel switch does nothing at the float32 base
    calls.clear()
    a = explain_batch(model, imgs, torch.tensor([-1, 1]), ops=ops,
                      block_kernel=False)
    assert calls == {"attn_fwd_core": L, "attn_rev_core": L,
                     "rollout_from_grad_cam": 1}
    torch.testing.assert_close(a, explain_batch(model, imgs,
                                                torch.tensor([-1, 1])),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kw,raises", [
    # the tf32 split arm (B4, B5, the plain MLP arm) and a tensorfloat32
    # attention island on the bfloat16 one run since the bf16×3 instances
    (dict(matmul_precision="tensorfloat32", relprop_precision="bfloat16",
          attn_precision="float32"), None),
    # islands above the base are the non-kernel branch's, not the split
    # path's
    (dict(matmul_precision="bfloat16", relprop_precision="tensorfloat32"),
     None),
    (dict(matmul_precision="bfloat16", mlp_precision="float32"), None),
    (dict(matmul_precision="bfloat16", attn_precision="tensorfloat32"),
     None),
    (dict(matmul_precision="bfloat16", attn_precision="float32"), None),
    (dict(matmul_precision="bfloat16", relprop_precision="bfloat16",
          mlp_precision="bfloat16"), None),
    (dict(matmul_precision="float32"), None),
])
def test_split_path_gates(kw, raises):
    if raises is None:
        check_precision(**kw, block_kernel=False)
    else:
        with pytest.raises(NotImplementedError, match=raises):
            check_precision(**kw, block_kernel=False)


def test_split_model_entry_points_raise_at_tensorfloat32():
    """The model entry points of the tf32 split arm, which raised until B4
    and B5 had bf16×3 instances, run: forward_collect and reverse_pass
    compose to explain_batch's heatmap, and take B4 and B5 a block and no
    B6 (the plain MLP arm)."""
    cfg = ViTConfig(**SMALL)
    model = VisionTransformer(cfg, dtype=torch.float64)
    model.load_state_dict(_weights(SMALL))
    imgs = torch.from_numpy(np.random.RandomState(6).randn(1, 3, 32, 32))
    kw = dict(matmul_precision="tensorfloat32", block_kernel=False)
    calls, ops = _counting_ops()
    _, res = tvit.forward_collect(model, imgs, ops, **kw)
    onehot = torch.nn.functional.one_hot(torch.tensor([1]), 10).double()
    _, gc, _ = tvit.reverse_pass(model, res, onehot, ops=ops, **kw)
    heat = ops.rollout_from_grad_cam(gc, 0, rows=1)[:, 0, 1:]
    assert calls == {"attn_fwd_core": cfg.depth, "attn_rev_core": cfg.depth,
                     "rollout_from_grad_cam": 1}
    torch.testing.assert_close(heat, explain_batch(
        model, imgs, torch.tensor([1]), **kw), rtol=0, atol=0)
