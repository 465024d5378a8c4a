"""The port's ViT paths at the reduced bases and under precision islands
against the JAX package: the mode of every product, and the structure.

* **Per product** (:mod:`torch_precision_oracle`): JAX's ``explain_single``
  is lowered on the CPU for a small config and each ``dot_general``'s
  operand shapes and precision are read off the program; the port runs the
  same call on one sample with a hook on ``precision.product`` recording
  each product's shapes and mode. The two sets must be equal: every port
  product is in JAX's program in the same mode, and every product JAX
  lowers, exact float32 included, is one the port runs (a rule island
  above the base shows as JAX's float32 rule products, which a port that
  ran its rules at the base would lack). JAX's lowering drops dead code,
  so a product whose result no output reads is not in its program: the
  one such product of the port, the logits of a method that reads no
  class (``last_layer_attn``, ``rollout_attn``), is taken out of the
  port's set before the comparison (:func:`_dead`). A live product JAX
  computes twice (the gradient tail re-runs the head) is one key. JAX's
  rollout chain is its Pallas kernel on its TPU, pinned to HIGHEST; on the
  CPU its jnp fallback would take the ambient precision, so it is lowered
  here under ``default_matmul_precision("float32")`` as the TPU pins it;
  the port's chain, B1, runs its plain version on the CPU, whose products
  go through ``precision.product`` at float32 and are compared. On the
  float32 base's kernel branch JAX's B4 and B5 are replaced in the
  lowering by stubs of the same shapes with no products: the port's B4
  and B5 plain versions round in their island modes by ``kdot`` directly,
  which the hook does not see either.
* **Structure**: with every product's rounding turned off, the port's new
  paths in float64 equal JAX's float64 paths (which compute exactly at any
  precision on the CPU) at rtol 1e-8; the kernel branch's B4 and B5 keep
  their bf16 roundings, which JAX's kernels reproduce in Pallas interpret
  mode.
* **Bitwise**: the default float32 path is bitwise the parent commit's
  (``tests/golden/torch_float32_paths.npz``,
  ``experiments/torch_float32_golden.py``).
* **What raised** for want of a kernel mode (ROADMAP B item 1) runs since
  the bf16×3 instances; the tensor-parallel islands still raise naming
  A8, and the harnesses run one batch at ``production`` with a non-fused
  method.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain import generator as jgen
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_torch import Explainer
from transformer_explainability_torch.explain.generator import (
    METHODS, precision_kwargs)
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

from torch_precision_oracle import (
    assert_same_products, jax_products, port_products, rounding_off)

# distinct product shapes: n = 5 tokens, D = 32, 2 heads of 16, M = 128
TINY = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
            num_classes=10)
# a 4 × 4 patch grid, so that attn_gradcam's map is not degenerate
SMALL = dict(img_size=64, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)
RTOL, ATOL = 1e-8, 1e-12
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_float32_paths.npz")

REDUCED = ("bfloat16", "production", "tensorfloat32")
OFF_KERNEL = [m for m in METHODS
              if m not in ("transformer_attribution", "grad")]
ISLANDS = {
    # an island above the base: the whole program off the kernel branch
    "bf16-base-f32-rules": dict(matmul_precision="bfloat16",
                                relprop_precision="float32"),
    "tf32-base-f32-rules": dict(matmul_precision="tensorfloat32",
                                relprop_precision="float32",
                                attn_precision="float32"),
    # islands on the float32 base: the kernel branch, B4 and B5 in bf16
    "f32-base-bf16-attn-rules": dict(matmul_precision="float32",
                                     attn_precision="bfloat16",
                                     relprop_precision="bfloat16"),
}
CASES = ([(m, p, {}) for p in REDUCED for m in OFF_KERNEL]
         + [(m, p, dict(variant="lrp")) for p in REDUCED
            for m in ("transformer_attribution", "grad")]
         + [("transformer_attribution", p, dict(alpha=2.0)) for p in REDUCED]
         + [("transformer_attribution", k, {}) for k in ISLANDS])


def _kwargs(preset):
    return dict(ISLANDS[preset]) if preset in ISLANDS else precision_kwargs(
        preset)


def _weights(fields, dtype=np.float32):
    jcfg = jvit.ViTConfig(**fields)
    tree = jax.tree.map(lambda a: np.asarray(a).astype(dtype),
                        jvit.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), vit_params_from_jax(
        tree, ViTConfig(**fields))


@pytest.fixture
def jax_tpu_lowering(monkeypatch):
    """JAX's program as its TPU runs it, for the product comparison: the
    rollout chain pinned to HIGHEST, B4 and B5 stubbed (no products)."""
    chain = pk.rollout_from_grad_cam

    def pinned(*a, **kw):
        with jax.default_matmul_precision("float32"):
            return chain(*a, **kw)

    # the stubs' outputs depend on every input, so that the lowering keeps
    # the products around them
    def attn_fwd(qkv, num_heads, head_dim, scale, **kw):
        return qkv[:, : num_heads * head_dim]

    def attn_rev(qkv, g_om, cam_o, num_heads, head_dim, scale, **kw):
        n = qkv.shape[0]
        t = qkv.sum() + g_om.sum() + cam_o.sum()
        return qkv + t, qkv - t, jnp.full((n, n), t)

    monkeypatch.setattr(pk, "rollout_from_grad_cam", pinned)
    monkeypatch.setattr(pk, "attn_fwd_core", attn_fwd)
    monkeypatch.setattr(pk, "attn_rev_core", attn_rev)


def _dead(method, cfg):
    """The keys of the port's products that are dead for ``method``: the
    head's, where the method reads no class."""
    if METHODS[method] != (False, False):
        return set()
    return {(1, cfg["embed_dim"], (1, cfg["num_classes"]))}


def _case_id(c):
    m, p, kw = c
    return "-".join([m, p] + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_vit_products_follow_jax_lowered_program(jax_tpu_lowering, case):
    method, preset, kw = case
    pkw = _kwargs(preset)
    jcfg, params, sd = _weights(TINY)
    img = np.random.RandomState(1).randn(1, 3, 32, 32).astype(np.float32)
    kernel = pkw.get("matmul_precision") == "float32"
    lowered = jax_products(
        lambda p, x, i: jgen.explain_single(
            p, x, i, jcfg, method=method, use_attn_kernel=kernel, **kw,
            **pkw),
        params, jnp.asarray(img[0]), jnp.int32(3))
    variant = kw.get("variant", "ours")
    ex = Explainer(sd, ViTConfig(**TINY), "cpu", variant=variant, **pkw)
    with port_products() as seen:
        heat = ex.explain(img, [3], method=method, alpha=kw.get("alpha", 1.0))
    assert heat.shape[0] == 1
    dead = _dead(method, TINY)
    assert_same_products({p for p in seen if p[0] not in dead}, lowered)
    modes = {m for _, m in seen}
    assert modes - {"float32"}, "no reduced product ran"


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


F64_CASES = ([(m, "production", {}) for m in OFF_KERNEL]
             + [("transformer_attribution", "production",
                 dict(variant="lrp")),
                ("grad", "bfloat16", dict(alpha=2.0)),
                ("rollout", "tensorfloat32", dict(start_layer=1))]
             + [("transformer_attribution", k, {}) for k in ISLANDS])


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """JAX's B4 and B5 in Pallas interpret mode, which rounds in their
    modes as the TPU does (their CPU fallback computes exactly)."""
    for name in ("attn_fwd_core", "attn_rev_core"):
        fn = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda *a, _fn=fn, **kw: _fn(
            *a, **kw, interpret=True))


@pytest.mark.parametrize("case", F64_CASES,
                         ids=[_case_id(c) for c in F64_CASES])
def test_vit_new_paths_match_jax_f64(x64, jax_kernels_interpreted, case):
    method, preset, kw = case
    pkw = _kwargs(preset)
    jcfg, params, sd = _weights(SMALL, np.float64)
    imgs = np.random.RandomState(2).randn(2, 3, 64, 64)
    idx = np.array([3, -1])
    kernel = pkw.get("matmul_precision") == "float32"
    fn = jax.jit(jax.vmap(lambda p, x, i: jgen.explain_single(
        p, x, i, jcfg, method=method, use_attn_kernel=kernel, **kw, **pkw),
        in_axes=(None, 0, 0)))
    want = np.asarray(fn(params, jnp.asarray(imgs), jnp.asarray(idx,
                                                                 jnp.int32)))
    variant = kw.pop("variant", "ours")
    ex = Explainer(sd, ViTConfig(**SMALL), "cpu", variant=variant, **pkw)
    with rounding_off():
        got = ex.explain(imgs, idx, method=method, **kw).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_vit_float32_path_is_bitwise_the_parents():
    """Every method (and lrp, α = 2) of the default float32 path, float32
    on the CPU, bitwise as the parent commit computed it."""
    gold = np.load(GOLDEN)
    _, _, sd = _weights(SMALL)
    imgs = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    ex = Explainer(sd, ViTConfig(**SMALL), "cpu")
    ex_lrp = Explainer(sd, ViTConfig(**SMALL), "cpu", variant="lrp")
    for m in METHODS:
        got = ex.explain(imgs, [3, -1], method=m).numpy()
        np.testing.assert_array_equal(got, gold[f"vit_{m}"])
    np.testing.assert_array_equal(
        ex.explain(imgs, [3, -1], alpha=2.0).numpy(), gold["vit_alpha2"])
    np.testing.assert_array_equal(ex_lrp.explain(imgs, [3, -1]).numpy(),
                                  gold["vit_lrp"])


@pytest.mark.parametrize("kw", [
    dict(matmul_precision="tensorfloat32"),                  # raw tf32
    dict(matmul_precision="tensorfloat32", relprop_precision="bfloat16",
         attn_precision="float32", block_kernel=False),     # tf32 split arm
    dict(matmul_precision="float32", attn_precision="tensorfloat32"),
    dict(matmul_precision="float32", relprop_precision="tensorfloat32"),
])
def test_modes_without_a_kernel_raise(kw):
    """The fused method's tensorfloat32 kernel modes, which raised until
    their kernels had bf16×3 instances (ROADMAP A3b), run on the kernel
    branch (held to JAX: tests/test_torch_vit_tf32.py,
    test_torch_vit_presets.py); its other methods run in them too."""
    _, _, sd = _weights(TINY)
    img = np.random.RandomState(5).randn(1, 3, 32, 32).astype(np.float32)
    ex = Explainer(sd, ViTConfig(**TINY), "cpu", **kw)
    heat = ex.explain(img)
    assert heat.shape == (1, 4) and torch.isfinite(heat).all()
    assert ex.explain(img, method="rollout").shape == (1, 4)


@pytest.mark.parametrize("kw", [
    dict(matmul_precision="float32", attn_precision="bfloat16"),
    dict(matmul_precision="float32", relprop_precision="bfloat16"),
    dict(matmul_precision="bfloat16", relprop_precision="float32"),
    dict(matmul_precision="bfloat16", mlp_precision="float32"),
])
def test_tensor_parallel_islands_raise(kw):
    """The tensor-parallel program keeps raising for the islands it does
    not run (JAX's TP islands are ROADMAP A8), before it reads the group."""
    from transformer_explainability_torch.parallel.tensor import (
        make_tp_explain_fn)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        make_tp_explain_fn(ViTConfig(**TINY), group=None, device="cpu", **kw)


def test_harnesses_run_a_batch_at_production(tmp_path):
    """The three harnesses at ``--precision production`` with methods off
    the kernel branch, one batch each: seg with ``rollout``, visualize with
    ``full_lrp`` (its ``results.hdf5``), perturbation over that file."""
    from transformer_explainability_torch.data.expl_hdf5 import (
        ImagenetResults)
    from transformer_explainability_torch.eval import perturbation as tpert
    from transformer_explainability_torch.eval import seg as tseg
    from transformer_explainability_torch.eval import visualize as tvis
    _, _, sd = _weights(TINY)
    cfg = ViTConfig(**TINY)
    rng = np.random.RandomState(0)
    ds = [(rng.randn(3, 32, 32).astype(np.float32),
           (rng.rand(32, 32) > 0.5).astype(np.int64)) for _ in range(4)]
    got = tseg.run_seg_eval(ds, sd, cfg, method="rollout",
                            precision="production", batch_size=4,
                            progress=False, device="cpu")
    assert all(np.isfinite(v).all() for v in got.values())
    imgs = rng.rand(4, 3, 32, 32).astype(np.float32)
    path = str(tmp_path / "results.hdf5")
    assert tvis.compute_saliency_and_save(
        iter([(imgs, np.array([1, 2, 3, 4]))]), sd, path, cfg, "full_lrp",
        "target", precision="production", device="cpu") == 4
    _, vis, _ = ImagenetResults(path)[:]
    assert vis.shape == (4, 1, 32, 32) and np.isfinite(vis).all()
    pert = tpert.run_perturbation_eval(ImagenetResults(path), sd, cfg,
                                       batch_size=4, progress=False,
                                       device="cpu")
    assert pert["perturbations_hits"].shape[1] == 4
