"""The port's ViT methods, rule variants and α against the JAX package.

Same weights both ways (JAX ``init_params`` exported with the port's
converter), same numpy inputs, float64 on the CPU. JAX's ``explain_single``
on the CPU takes its non-kernel path with exact products; the port takes
its non-kernel branch at the float32 base for every method but
``transformer_attribution`` with ``ours`` at α=1, which keeps the kernel
branch. rtol 1e-8, atol 1e-12, as for the other slices. Then the two ViT
branches against each other, the hand-written block backward against
autograd, and the reference Baselines entry points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain.generator import (
    Explainer as JaxExplainer, explain_single)
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_torch import Explainer
from transformer_explainability_torch.explain.generator import (
    METHODS, _one_hot_index, explain_batch)
from transformer_explainability_torch.models import vit as tvit
from transformer_explainability_torch.models.vit import (
    ViTConfig, VisionTransformer)
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

# a 4 × 4 patch grid, so that attn_gradcam's map is not degenerate
SMALL = dict(img_size=64, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)
WIDE = dict(depth=2)                      # ViT-B/16 widths, two blocks
RTOL, ATOL = 1e-8, 1e-12


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
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float64),
                        jvit.init_params(jax.random.PRNGKey(key), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), vit_params_from_jax(
        tree, ViTConfig(**fields))


def _inputs(fields, n):
    s = fields.get("img_size", 224)
    imgs = np.random.RandomState(2).randn(n, 3, s, s)
    return imgs, np.array([3, -1, 7][:n])


def _jax_batch(jcfg, params, imgs, idx, **kw):
    fn = jax.jit(jax.vmap(lambda p, x, i: explain_single(p, x, i, jcfg, **kw),
                          in_axes=(None, 0, 0)))
    return np.asarray(fn(params, jnp.asarray(imgs),
                         jnp.asarray(idx, jnp.int32)))


def _compare(fields, n, variant="ours", **kw):
    jcfg, params, sd = _weights(fields)
    imgs, idx = _inputs(fields, n)
    ex = Explainer(sd, ViTConfig(**fields), device="cpu", variant=variant)
    got = ex.explain(imgs, idx, **kw).numpy()
    want = _jax_batch(jcfg, params, imgs, idx, variant=variant, **kw)
    assert got.shape == want.shape and got.dtype == np.float64
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return got


CASES = ([dict(method=m) for m in METHODS]
         + [dict(method="last_layer", is_ablation=True),
            dict(method="second_layer", is_ablation=True),
            dict(method="rollout", start_layer=1),
            dict(method="rollout_attn", start_layer=2),
            dict(method="transformer_attribution", start_layer=1, alpha=2.0),
            dict(method="transformer_attribution", variant="lrp"),
            dict(method="rollout", alpha=2.0),
            dict(method="rollout", variant="lrp"),
            dict(method="full", variant="lrp")])


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(f"{k}={v}" for k, v in c.items())
                              for c in CASES])
def test_methods_match_jax_f64(x64, case):
    got = _compare(SMALL, 3, **case)
    cfg = ViTConfig(**SMALL)
    if case["method"] == "full":
        assert got.shape == (3, cfg.img_size, cfg.img_size)
    elif case["method"] == "attn_gradcam":
        assert got.shape == (3, cfg.grid, cfg.grid)
        assert (got.min(axis=(1, 2)) == 0).all()
        assert (got.max(axis=(1, 2)) == 1).all()
    else:
        assert got.shape == (3, cfg.num_patches)


@pytest.mark.parametrize("method", ["full", "attn_gradcam"])
def test_methods_at_vit_b_width_match_jax_f64(x64, method):
    """ViT-B widths (D=768, h=12, n=197, M=3072) at depth 2, one image."""
    got = _compare(WIDE, 1, method=method)
    assert got.shape == ((1, 224, 224) if method == "full" else (1, 14, 14))


def test_baselines_entry_points_match_jax(x64):
    jcfg, params, sd = _weights(SMALL, key=1)
    imgs, idx = _inputs(SMALL, 3)
    ex = Explainer(sd, ViTConfig(**SMALL), device="cpu")
    jex = JaxExplainer(params, jcfg)
    np.testing.assert_allclose(
        ex.generate_rollout(imgs, start_layer=1).numpy(),
        np.asarray(jex.generate_rollout(imgs, start_layer=1)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ex.generate_cam_attn(imgs, idx).numpy(),
        np.asarray(jex.generate_cam_attn(imgs, idx)), rtol=RTOL, atol=ATOL)


def _model(fields, key=0):
    cfg = ViTConfig(**fields)
    model = VisionTransformer(cfg, dtype=torch.float64)
    model.load_state_dict(_weights(fields, key)[2])
    model.requires_grad_(False)
    return cfg, model


@pytest.mark.parametrize("start_layer", [0, 2])
def test_non_kernel_branch_equals_kernel_branch(start_layer):
    """transformer_attribution through the non-kernel branch (plain blocks,
    fused reverse) equals the kernel branch the generator takes."""
    cfg, model = _model(SMALL, key=2)
    imgs, idx = _inputs(SMALL, 3)
    imgs = torch.from_numpy(imgs)
    want = explain_batch(model, imgs, torch.from_numpy(idx), start_layer)
    logits, res = tvit.forward_collect(model, imgs, use_attn_kernel=False)
    assert res.outs is None and res.attns.shape == (
        3, cfg.depth, cfg.num_heads, cfg.num_tokens, cfg.num_tokens)
    onehot = _one_hot_index(logits, torch.from_numpy(idx), cfg.num_classes)
    _, gc, none = tvit.reverse_pass(model, res, onehot,
                                    use_attn_kernel=False)
    assert none is None and gc.shape == (3, cfg.depth, cfg.num_tokens,
                                         cfg.num_tokens)
    got = K.rollout_from_grad_cam(gc, start_layer)[:, 0, 1:]
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_relprop_matches_jax(x64):
    """The relevance-only reverse: tokens and per-block cams."""
    jcfg, params, sd = _weights(SMALL)
    cfg, model = _model(SMALL)
    imgs, _ = _inputs(SMALL, 2)
    R_logits = np.random.RandomState(3).randn(2, cfg.num_classes)
    _, res = tvit.forward_collect(model, torch.from_numpy(imgs),
                                  use_attn_kernel=False)
    R_tok, cams = tvit.relprop(model, res, torch.from_numpy(R_logits),
                               variant="lrp")
    for i in range(2):
        _, jres = jvit.forward_collect(params, jnp.asarray(imgs[i]), jcfg)
        jR, jcams = jvit.relprop(params, jres, jnp.asarray(R_logits[i]), jcfg,
                                 variant="lrp")
        np.testing.assert_allclose(R_tok[i].numpy(), np.asarray(jR),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(cams[i].numpy(), np.asarray(jcams),
                                   rtol=RTOL, atol=ATOL)


def test_block_backward_equals_autograd():
    """The hand-written block VJP against torch.autograd of a plain block
    forward with a zero tap on the post-softmax attention (the reference's
    attention hook)."""
    cfg, model = _model(SMALL, key=3)
    blk = model.blocks[1]
    rng = np.random.RandomState(4)
    x_in = torch.from_numpy(rng.randn(2, cfg.num_tokens, cfg.embed_dim))
    g_out = torch.from_numpy(rng.randn(*x_in.shape))
    h, hd = cfg.num_heads, cfg.head_dim
    F = torch.nn.functional

    def block(x, tap):
        y = blk.attn.qkv(F.layer_norm(x, (cfg.embed_dim,), blk.norm1.weight,
                                      blk.norm1.bias, blk.norm1.eps))
        q, k, v = bm.split_heads(y, h, hd)
        attn = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5,
                             dim=-1) + tap
        x_mid = x + blk.attn.proj(bm.merge_heads(attn @ v))
        m = F.layer_norm(x_mid, (cfg.embed_dim,), blk.norm2.weight,
                         blk.norm2.bias, blk.norm2.eps)
        return x_mid + blk.mlp.fc2(F.gelu(blk.mlp.fc1(m)))

    tap = torch.zeros(2, h, cfg.num_tokens, cfg.num_tokens,
                      dtype=torch.float64, requires_grad=True)
    x = x_in.clone().requires_grad_(True)
    with torch.enable_grad():
        want_x, want_tap = torch.autograd.grad((block(x, tap) * g_out).sum(),
                                               (x, tap))
    x_mid, _, acts = tvit._block_acts(x_in, blk, cfg)
    g_in, g_attn = tvit.block_backward(g_out, x_in, x_mid, acts, blk, cfg)
    torch.testing.assert_close(g_in, want_x, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(g_attn, want_tap, rtol=1e-10, atol=1e-12)


def test_unfused_reverse_returns_cams_and_grads():
    cfg, model = _model(SMALL)
    imgs, idx = _inputs(SMALL, 2)
    logits, res = tvit.forward_collect(model, torch.from_numpy(imgs),
                                       use_attn_kernel=False)
    onehot = torch.nn.functional.one_hot(torch.tensor([1, 2]), 10).double()
    shape = (2, cfg.depth, cfg.num_heads, cfg.num_tokens, cfg.num_tokens)
    R, cams, grads = tvit.reverse_pass(model, res, onehot,
                                       fuse_grad_cam=False,
                                       use_attn_kernel=False)
    assert R.shape == (2, cfg.num_tokens, cfg.embed_dim)
    assert cams.shape == grads.shape == shape
    # the fused form is their head-mean (grad ⊙ cam)⁺
    _, gc, _ = tvit.reverse_pass(model, res, onehot, use_attn_kernel=False)
    torch.testing.assert_close(gc, (grads * cams).clamp(min=0).mean(dim=2),
                               rtol=1e-12, atol=0)
    _, no_cams, grads_only = tvit.reverse_pass(
        model, res, onehot, need_relprop=False, fuse_grad_cam=False,
        use_attn_kernel=False)
    assert no_cams is None
    torch.testing.assert_close(grads_only, grads, rtol=0, atol=0)
    with pytest.raises(ValueError, match="both passes"):
        tvit.reverse_pass(model, res, onehot, need_grads=False,
                          use_attn_kernel=False)
