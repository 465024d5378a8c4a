"""The guarded mode's diagnostics and the split MLP precisions of the port
against the JAX package.

``with_diagnostics=True`` returns each sample's ``DIAG_FIELDS`` vector
beside the heatmap: the rollout's inputs and output and the trunk
statistics that every branch of the reverse takes after each block (the
kernel branch in the float32 preset and on the megakernel path, through
the kernels' plain versions on the CPU, and the non-kernel branch with
``variant="lrp"``). Same weights both ways, float64 on the CPU; the vector
is float32 in both packages, held at rtol 1e-8 (the float64 values agree
far below a float32 ulp, so the float32 fields come out equal). The heatmap
must be bitwise the same with and without the diagnostics.

``mlp_fwd_precision`` / ``mlp_bwd_precision`` split ``mlp_precision``
between the forward's and the reverse's MLP products; in the ``production``
and ``bfloat16`` presets (the megakernel path) the port is held to JAX's
``explain_single`` with the same split at rtol 1e-8, as
``tests/test_torch_vit_presets.py`` holds the presets.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain import generator as jgen
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_torch import Explainer
from transformer_explainability_torch.explain.generator import (
    DIAG_FIELDS, _one_hot_index, check_precision, explain_batch,
    make_explain_fn, precision_kwargs)
from transformer_explainability_torch.models import vit as tvit
from transformer_explainability_torch.models.vit import (
    ViTConfig, VisionTransformer)
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

SMALL = dict(img_size=32, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)
DIST = dict(SMALL, distilled=True)
RTOL, ATOL = 1e-8, 1e-12
# (label, port kwargs, JAX kwargs): the branches the diagnostics run on
BRANCHES = {
    "float32 kernel branch": ({}, {}),
    "lrp non-kernel branch": (dict(variant="lrp"), dict(variant="lrp")),
    "production megakernels": (precision_kwargs("production"),
                               dict(use_attn_kernel=True,
                                    **jgen.PRECISION_PRESETS["production"])),
    "bfloat16 megakernels": (precision_kwargs("bfloat16"),
                             dict(use_attn_kernel=True,
                                  **jgen.PRECISION_PRESETS["bfloat16"])),
}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@functools.lru_cache(maxsize=None)
def _tree(items, key):
    """The JAX init of a config as a float64 numpy tree (made once)."""
    jcfg = jvit.ViTConfig(**dict(items))
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float64),
                        jvit.init_params(jax.random.PRNGKey(key), jcfg))


def _weights(fields, key=0):
    """(JAX config, JAX f64 params, port f64 state dict) of the same init."""
    tree = _tree(tuple(sorted(fields.items())), key)
    return (jvit.ViTConfig(**fields), jax.tree.map(jnp.asarray, tree),
            vit_params_from_jax(tree, ViTConfig(**fields)))


def _inputs(n=3, seed=4):
    return (np.random.RandomState(seed).randn(n, 3, 32, 32),
            np.array([3, -1, 7, 0][:n]))


def _jax_batch(jcfg, params, imgs, idx, **kw):
    fn = jax.jit(jax.vmap(lambda p, x, i: jgen.explain_single(
        p, x, i, jcfg, **kw), in_axes=(None, 0, 0)))
    out = fn(params, jnp.asarray(imgs), jnp.asarray(idx, jnp.int32))
    return jax.tree.map(np.asarray, out)


def test_diag_fields_are_jax_fields():
    assert DIAG_FIELDS == jgen.DIAG_FIELDS


@pytest.mark.parametrize("fields", [SMALL, DIST], ids=["vit", "distilled"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_diagnostics_match_jax_f64(x64, fields, branch):
    port_kw, jax_kw = BRANCHES[branch]
    jcfg, params, sd = _weights(fields)
    imgs, idx = _inputs()
    ex = Explainer(sd, ViTConfig(**fields), device="cpu", **port_kw)
    heat, diag = ex.explain(imgs, idx, with_diagnostics=True)
    want_heat, want_diag = _jax_batch(jcfg, params, imgs, idx,
                                      with_diagnostics=True, **jax_kw)
    assert diag.shape == (3, len(DIAG_FIELDS))
    assert diag.dtype == torch.float32 and want_diag.dtype == np.float32
    assert torch.isfinite(diag).all()
    np.testing.assert_allclose(heat.numpy(), want_heat, rtol=RTOL, atol=ATOL)
    for f, name in enumerate(DIAG_FIELDS):
        np.testing.assert_allclose(diag[:, f].numpy(), want_diag[:, f],
                                   rtol=RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("kw", [
    {}, dict(variant="lrp"), dict(method="grad"),
    precision_kwargs("production"), precision_kwargs("bfloat16"),
    dict(precision_kwargs("bfloat16"), block_kernel=False),
    dict(precision_kwargs("production"), mlp_fwd_precision="bfloat16",
         mlp_bwd_precision="tensorfloat32")],
    ids=["float32", "lrp", "grad", "production", "bfloat16", "split",
         "mlp-split"])
def test_heatmap_bitwise_with_and_without_diagnostics(kw):
    """float32 weights: the diagnostics' reductions leave the heatmap as it
    is, bit for bit, on every branch."""
    cfg = ViTConfig(**DIST)
    model = VisionTransformer(cfg, dtype=torch.float32)
    model.load_state_dict(tvit.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    imgs = torch.from_numpy(_inputs(4)[0]).float()
    idx = torch.from_numpy(_inputs(4)[1])
    plain = explain_batch(model, imgs, idx, **kw)
    heat, diag = explain_batch(model, imgs, idx, with_diagnostics=True, **kw)
    assert torch.equal(plain.view(torch.int32), heat.view(torch.int32))
    assert diag.shape == (4, 10) and torch.isfinite(diag).all()


def test_diagnostics_are_for_the_fused_method_only():
    _, _, sd = _weights(SMALL)
    cfg = ViTConfig(**SMALL)
    imgs, idx = _inputs()
    ex = Explainer(sd, cfg, device="cpu")
    for method in ("rollout", "full", "attn_gradcam", "rollout_attn"):
        with pytest.raises(ValueError, match="transformer_attribution"):
            ex.explain(imgs, idx, method=method, with_diagnostics=True)
    with pytest.raises(ValueError, match="transformer_attribution"):
        make_explain_fn(cfg, "cpu", method="rollout", with_diagnostics=True)
    heat, diag = make_explain_fn(cfg, "cpu", with_diagnostics=True)(
        ex.model, imgs, idx)
    assert heat.shape == (3, 4) and diag.shape == (3, 10)


def test_reverse_pass_trunk_stats():
    """(B, L, 4) float32 per block after its step, on the fused reverse
    only; block 0's relevance statistics are those of the returned
    R_tokens."""
    _, _, sd = _weights(SMALL)
    cfg = ViTConfig(**SMALL)
    model = VisionTransformer(cfg, dtype=torch.float64)
    model.load_state_dict(sd)
    model.requires_grad_(False)
    imgs, idx = _inputs()
    logits, res = tvit.forward_collect(model, torch.from_numpy(imgs),
                                       use_attn_kernel=False)
    onehot = _one_hot_index(logits, torch.from_numpy(idx), 10)
    R, gc, none, trunk = tvit.reverse_pass(
        model, res, onehot, use_attn_kernel=False, with_trunk_stats=True)
    assert none is None and trunk.shape == (3, cfg.depth, 4)
    assert trunk.dtype == torch.float32
    np.testing.assert_allclose(trunk[:, 0, 2].numpy(),
                               R.abs().flatten(1).amax(1).float().numpy())
    np.testing.assert_allclose(trunk[:, 0, 3].numpy(),
                               R.abs().flatten(1).sum(1).float().numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="fused"):
        tvit.reverse_pass(model, res, onehot, fuse_grad_cam=False,
                          use_attn_kernel=False, with_trunk_stats=True)


SPLITS = [("production", "bfloat16", "tensorfloat32"),
          ("production", "tensorfloat32", "bfloat16"),
          ("production", None, "tensorfloat32"),
          ("bfloat16", "bfloat16", "bfloat16")]


@pytest.mark.parametrize("fields", [SMALL, DIST], ids=["vit", "distilled"])
@pytest.mark.parametrize("preset,fwd,bwd", SPLITS)
def test_mlp_split_matches_jax_f64(x64, fields, preset, fwd, bwd):
    jcfg, params, sd = _weights(fields, key=1)
    imgs, idx = _inputs()
    split = dict(mlp_fwd_precision=fwd, mlp_bwd_precision=bwd)
    ex = Explainer(sd, ViTConfig(**fields), device="cpu",
                   **precision_kwargs(preset), **split)
    got = ex.explain(imgs, idx).numpy()
    want = _jax_batch(jcfg, params, imgs, idx, use_attn_kernel=True,
                      **jgen.PRECISION_PRESETS[preset], **split)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mlp_split_sides_are_independent():
    """On the megakernel path the forward's MLP mode forms the fc1 / fc2
    anchors and the reverse's runs B3's MLP gradient products: (bf16 fwd,
    tf32 bwd) differs from both uniform settings."""
    cfg = ViTConfig(**SMALL)
    model = VisionTransformer(cfg, dtype=torch.float64)
    model.load_state_dict(_weights(SMALL)[2])
    model.requires_grad_(False)
    imgs, idx = (torch.from_numpy(a) for a in _inputs())
    base = dict(precision_kwargs("production"), mlp_precision=None)

    def run(**mlp):
        return explain_batch(model, imgs, idx, **dict(base, **mlp))

    bf16, tf32 = run(mlp_precision="bfloat16"), run(
        mlp_precision="tensorfloat32")
    mixed = run(mlp_fwd_precision="bfloat16",
                mlp_bwd_precision="tensorfloat32")
    assert not torch.equal(mixed, bf16) and not torch.equal(mixed, tf32)
    assert torch.equal(run(mlp_precision="bfloat16",
                           mlp_fwd_precision="bfloat16"), bf16)


@pytest.mark.parametrize("kw,raises,match", [
    # an MLP island above the base takes the non-kernel branch; on the
    # float32 base the kernel branch's plain MLP arm runs at the base
    (dict(matmul_precision="tensorfloat32", relprop_precision="bfloat16",
          attn_precision="float32", mlp_bwd_precision="float32"),
     None, None),
    (dict(matmul_precision="bfloat16", mlp_fwd_precision="tensorfloat32"),
     None, None),
    (dict(matmul_precision="float32", mlp_fwd_precision="bfloat16"),
     None, None),
    (dict(matmul_precision="float32", mlp_bwd_precision="bfloat16"),
     None, None),
    (dict(matmul_precision="bfloat16", mlp_bwd_precision="fp8"),
     ValueError, "unknown precision"),
    # raw tensorfloat32 on the megakernels with a bf16 forward MLP: runs
    # since the bf16×3 attention and rule instances (ROADMAP A3b)
    (dict(matmul_precision="tensorfloat32", mlp_fwd_precision="bfloat16"),
     None, None),
    (dict(matmul_precision="tensorfloat32", relprop_precision="bfloat16",
          attn_precision="float32", mlp_fwd_precision="bfloat16",
          mlp_bwd_precision="tensorfloat32"), None, None),
])
def test_mlp_split_gates(kw, raises, match):
    if raises is None:
        check_precision(**kw)
        make_explain_fn(ViTConfig(**SMALL), "cpu", **kw)
        return
    with pytest.raises(raises, match=match):
        check_precision(**kw)
    with pytest.raises(raises, match=match):
        make_explain_fn(ViTConfig(**SMALL), "cpu", **kw)
