"""The port's other ViT configurations against the JAX package: ViT-L/16,
DeiT-base and DeiT-base distilled (the DIST token and its head).

Same weights both ways (JAX ``init_params`` exported with the port's
converter), same numpy inputs, float64 on the CPU, rtol 1e-8, atol 1e-12,
as for the ViT-B slices. JAX's ``explain_single`` takes its non-kernel path
on the CPU for the float32 preset and its jnp megakernel paths with
``use_attn_kernel=True`` for the others; the port takes its kernel branch
(the kernels' plain versions on the CPU) for ``transformer_attribution``
with ``ours`` at α=1 and its non-kernel branch for the rest. The distilled
config is tiny (a 4 × 4 patch grid, so that ``attn_gradcam``'s map is not
degenerate, D 32, two blocks); the ViT-L case is one block at ViT-L's
widths (D 1024, h 16, M 4096, n 197).

The tensor-parallel program on the distilled config is held to JAX in
``tests/test_torch_tp_distilled.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain.generator import (
    PRECISION_PRESETS as JAX_PRESETS, explain_single)
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_torch import Explainer
from transformer_explainability_torch.explain.generator import (
    METHODS, _one_hot_index, explain_batch, precision_kwargs)
from transformer_explainability_torch.models import vit as tvit
from transformer_explainability_torch.models.vit import (
    DEIT_BASE_16_224, DEIT_BASE_DISTILLED_16_224, VIT_BASE_16_224,
    VIT_LARGE_16_224, ViTConfig, VisionTransformer, init_params)
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

DIST = dict(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=4,
            num_classes=10, distilled=True)
LARGE = dict(embed_dim=1024, depth=1, num_heads=16)   # ViT-L widths, 1 block
RTOL, ATOL = 1e-8, 1e-12


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _weights(fields, key=0):
    """(JAX config, JAX f64 params, port f64 state dict) of the same init."""
    jcfg = jvit.ViTConfig(**fields)
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float64),
                        jvit.init_params(jax.random.PRNGKey(key), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), vit_params_from_jax(
        tree, ViTConfig(**fields))


def _inputs(fields, n, seed=2):
    s = fields.get("img_size", 224)
    imgs = np.random.RandomState(seed).randn(n, 3, s, s)
    return imgs, np.array([3, -1, 7][:n])


def _jax_batch(jcfg, params, imgs, idx, **kw):
    fn = jax.jit(jax.vmap(lambda p, x, i: explain_single(p, x, i, jcfg, **kw),
                          in_axes=(None, 0, 0)))
    return np.asarray(fn(params, jnp.asarray(imgs),
                         jnp.asarray(idx, jnp.int32)))


@pytest.fixture(scope="module")
def dist():
    jax.config.update("jax_enable_x64", True)
    try:
        return _weights(DIST)
    finally:
        jax.config.update("jax_enable_x64", False)


def _model(sd, fields):
    model = VisionTransformer(ViTConfig(**fields), dtype=torch.float64)
    model.load_state_dict(sd)
    model.requires_grad_(False)
    return model


@pytest.mark.parametrize("name", ["VIT_BASE_16_224", "VIT_LARGE_16_224",
                                  "DEIT_BASE_16_224",
                                  "DEIT_BASE_DISTILLED_16_224"])
def test_configs_have_jax_field_values(name):
    port, ref = getattr(tvit, name), getattr(jvit, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("grid", "num_patches", "num_prefix_tokens", "num_tokens",
                 "head_dim", "mlp_dim"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert name in tvit.__all__


def test_config_values():
    assert (VIT_LARGE_16_224.embed_dim, VIT_LARGE_16_224.depth,
            VIT_LARGE_16_224.num_heads, VIT_LARGE_16_224.mlp_dim,
            VIT_LARGE_16_224.head_dim) == (1024, 24, 16, 4096, 64)
    assert DEIT_BASE_16_224 == VIT_BASE_16_224
    assert DEIT_BASE_DISTILLED_16_224.num_prefix_tokens == 2
    assert DEIT_BASE_DISTILLED_16_224.num_tokens == 198


CASES = ([dict(method=m) for m in METHODS]
         + [dict(method="last_layer", is_ablation=True),
            dict(method="transformer_attribution", alpha=2.0),
            dict(method="transformer_attribution", variant="lrp"),
            dict(method="full", variant="lrp")])


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(f"{k}={v}" for k, v in c.items())
                              for c in CASES])
def test_distilled_methods_match_jax_f64(x64, dist, case):
    jcfg, params, sd = dist
    imgs, idx = _inputs(DIST, 3)
    variant = case.get("variant", "ours")
    kw = {k: v for k, v in case.items() if k != "variant"}
    ex = Explainer(sd, ViTConfig(**DIST), device="cpu", variant=variant)
    got = ex.explain(imgs, idx, **kw).numpy()
    want = _jax_batch(jcfg, params, imgs, idx, variant=variant, **kw)
    cfg = ViTConfig(**DIST)
    shape = {"full": (3, 64, 64), "attn_gradcam": (3, 4, 4)}.get(
        case["method"], (3, cfg.num_patches))
    assert got.shape == want.shape == shape and got.dtype == np.float64
    # attn_gradcam is 0/0 (NaN, in JAX too) on a map with no positive entry
    finite = np.isfinite(got).reshape(3, -1).all(axis=1)
    assert finite.all() or (case["method"] == "attn_gradcam" and finite.any())
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("preset", ["production", "bfloat16"])
def test_distilled_presets_match_jax_f64(x64, dist, preset):
    """The megakernel path (B2, B3 and B1 through their plain versions) on
    the distilled config."""
    jcfg, params, sd = dist
    imgs, idx = _inputs(DIST, 3)
    ex = Explainer(sd, ViTConfig(**DIST), device="cpu",
                   **precision_kwargs(preset))
    got = ex.explain(imgs, idx).numpy()
    want = _jax_batch(jcfg, params, imgs, idx, use_attn_kernel=True,
                      **JAX_PRESETS[preset])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_distilled_split_path_matches_megakernel_path(dist):
    """The split path (B4, B5, B6) against the megakernel path at the
    bfloat16 preset, as ``tests/test_torch_mlp_rev.py`` holds it at ViT-B."""
    _, _, sd = dist
    imgs, idx = _inputs(DIST, 3)
    bf16 = precision_kwargs("bfloat16")
    mega = Explainer(sd, ViTConfig(**DIST), device="cpu", **bf16)
    split = Explainer(sd, ViTConfig(**DIST), device="cpu",
                      block_kernel=False, **bf16)
    torch.testing.assert_close(split.explain(imgs, idx),
                               mega.explain(imgs, idx), rtol=RTOL, atol=ATOL)


def test_distilled_logits_and_relprop_match_jax_f64(x64, dist):
    """The fused logits of the forward, and ``relprop`` from them (the
    relevance seed's add rule between the two heads), per sample."""
    jcfg, params, sd = dist
    model = _model(sd, DIST)
    imgs, idx = _inputs(DIST, 3)
    logits, res = tvit.forward_collect(model, torch.from_numpy(imgs),
                                       use_attn_kernel=False)
    R_logits = _one_hot_index(logits, torch.from_numpy(idx), 10)
    R_tokens, cams = tvit.relprop(model, res, R_logits, alpha=2.0)

    def jax_one(p, x, r):
        jl, jres = jvit.forward_collect(p, x, jcfg)
        return (jl, *jvit.relprop(p, jres, r, jcfg, alpha=2.0))

    want = jax.jit(jax.vmap(jax_one, in_axes=(None, 0, 0)))(
        params, jnp.asarray(imgs), jnp.asarray(R_logits.numpy()))
    for got_, want_ in zip((logits, R_tokens, cams), want):
        np.testing.assert_allclose(got_.numpy(), np.asarray(want_),
                                   rtol=RTOL, atol=ATOL)
    assert R_tokens.shape == (3, ViTConfig(**DIST).num_tokens, 32)


def test_distilled_kernel_branch_takes_the_kernels(dist):
    """The kernel branch on the distilled config calls B4 and B5 once per
    block and B1 once (plain versions, through the ops table)."""
    _, _, sd = dist
    model = _model(sd, DIST)
    calls = {}

    def counted(name, f):
        def g(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return f(*a, **kw)
        return g

    ops = K.AttnOps(*(counted(n, f) for n, f in K.PLAIN_OPS._asdict()
                      .items()))
    imgs, idx = _inputs(DIST, 2)
    heat = explain_batch(model, torch.from_numpy(imgs),
                         torch.from_numpy(idx), ops=ops)
    assert heat.shape == (2, 16) and torch.isfinite(heat).all()
    assert calls == {"attn_fwd_core": 2, "attn_rev_core": 2,
                     "rollout_from_grad_cam": 1}


def test_converter_carries_the_distillation_token(dist):
    jcfg, params, sd = dist
    D, C = DIST["embed_dim"], DIST["num_classes"]
    assert sd["dist_token"].shape == (1, 1, D)
    np.testing.assert_array_equal(sd["dist_token"].numpy().reshape(D),
                                  np.asarray(params["dist_token"]).reshape(D))
    np.testing.assert_array_equal(sd["head_dist.weight"].numpy(),
                                  np.asarray(params["head_dist"]["kernel"]).T)
    np.testing.assert_array_equal(sd["head_dist.bias"].numpy(),
                                  np.asarray(params["head_dist"]["bias"]))
    assert sd["head_dist.weight"].shape == (C, D)
    # the module's state dict and the port's init_params have the same keys
    cfg = ViTConfig(**DIST)
    own = init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert set(own) == set(sd) == set(VisionTransformer(cfg).state_dict())
    assert own["dist_token"].shape == (1, 1, D)
    assert (own["head_dist.bias"] == 0).all()
    # a tree whose DIST token does not match the config is refused
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="distilled"):
        vit_params_from_jax(tree, ViTConfig(**dict(DIST, distilled=False)))
    tree.pop("dist_token")
    with pytest.raises(ValueError, match="distilled"):
        vit_params_from_jax(tree, cfg)


def test_embed_tokens_orders_cls_dist_patches(dist):
    _, _, sd = dist
    model = _model(sd, DIST)
    imgs = torch.from_numpy(_inputs(DIST, 2)[0])
    cat_x, x0 = tvit.embed(model, imgs)
    assert cat_x.shape == (2, 18, 32)
    torch.testing.assert_close(cat_x[:, 0], sd["cls_token"][0].expand(2, -1),
                               rtol=0, atol=0)
    torch.testing.assert_close(cat_x[:, 1], sd["dist_token"][0].expand(2, -1),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="DIST"):
        pe = model.patch_embed.proj
        tvit.embed_tokens(model.cfg, pe.weight, pe.bias, model.cls_token,
                          model.pos_embed, imgs)


def test_vit_large_width_block_matches_jax_f64(x64):
    """One block at ViT-L/16's widths (D 1024, h 16, M 4096, n 197), one
    image, the float32 kernel branch (B4, B5, B1 through their plain
    versions)."""
    jcfg, params, sd = _weights(LARGE)
    img = np.random.RandomState(5).randn(1, 3, 224, 224)
    got = Explainer(sd, ViTConfig(**LARGE), device="cpu").explain(
        img, [17]).numpy()
    want = _jax_batch(jcfg, params, img, np.array([17]))
    assert got.shape == (1, 196)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
