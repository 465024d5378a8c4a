"""The port's ViT trainer, its train-state checkpoints, batching helpers and
seeded weights against the JAX package, in float64 on the CPU.

Same weights both ways (JAX ``init_params`` exported with the port's
converter) and the same batches (numpy, from a seed). The JAX side is
``train.make_train_step`` (jitted, optax ``clip_by_global_norm`` then
``adamw``) at ``matmul_precision="float32"``: JAX on the CPU ignores the
matmul precision, so the reduced modes are held to the port's own
definition (``ops/precision.py: kdot``) instead. Tolerance rtol 1e-8 /
atol 1e-12.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer_explainability_tpu import train as jtrain
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.utils import batching as jbatching
from transformer_explainability_torch import train as ttrain
from transformer_explainability_torch.models import registry
from transformer_explainability_torch.models import vit as tvit
from transformer_explainability_torch.models.vit import (ViTConfig,
                                                         VisionTransformer)
from transformer_explainability_torch.ops import precision as prec
from transformer_explainability_torch.params import convert
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)
from transformer_explainability_torch.utils import batching as tbatching
from transformer_explainability_torch.utils.checkpoint import (
    has_train_state, restore_train_state, save_train_state)

SMALL = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
             num_classes=5)
RTOL, ATOL = 1e-8, 1e-12


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _weights(fields=SMALL, key=0):
    """(JAX config, JAX f64 pytree, port f64 model) of the same init."""
    jcfg = jvit.ViTConfig(**fields)
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float64),
                        jvit.init_params(jax.random.PRNGKey(key), jcfg))
    cfg = ViTConfig(**fields)
    model = VisionTransformer(cfg, dtype=torch.float64)
    model.load_state_dict(vit_params_from_jax(tree, cfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), model


def _batches(n_steps, B=4, fields=SMALL, seed=3):
    rng = np.random.RandomState(seed)
    s = fields["img_size"]
    return [(rng.randn(B, 3, s, s), rng.randint(0, fields["num_classes"],
                                                size=B))
            for _ in range(n_steps)]


def _assert_state(model, tree, cfg):
    want = vit_params_from_jax(jax.tree.map(np.asarray, tree), cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _jax_grad_norm(jcfg, params, imgs, labels):
    def loss(p):
        logits = jax.vmap(lambda im: jvit.forward(p, im, jcfg))(imgs)
        return jtrain.cross_entropy(logits, labels)
    return float(optax.global_norm(jax.grad(loss)(params)))


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_vit_train_steps_match_jax(clip):
    """Three steps of the trainer with weight decay on: each loss, then
    every weight, equal JAX's; the clip either scales every step's
    gradients or leaves them."""
    jcfg, params, model = _weights()
    batches = _batches(3)
    norm0 = _jax_grad_norm(jcfg, params, jnp.asarray(batches[0][0]),
                           jnp.asarray(batches[0][1]))
    max_norm = norm0 / 4 if clip == "active" else norm0 * 1e3
    lr, wd = 1e-4, 0.05
    jopt = jtrain.make_optimizer(lr, weight_decay=wd, max_grad_norm=max_norm)
    jstep = jtrain.make_train_step(jcfg, jopt, matmul_precision="float32")
    jstate = jopt.init(params)
    opt = ttrain.make_optimizer(lr, weight_decay=wd, max_grad_norm=max_norm)
    step = ttrain.make_train_step(ViTConfig(**SMALL), opt,
                                  matmul_precision="float32")
    state = opt.init(model)
    for imgs, labels in batches:
        params, jstate, jloss = jstep(params, jstate, jnp.asarray(imgs),
                                      jnp.asarray(labels))
        model, state, loss = step(model, state, imgs, labels)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL,
                                   atol=ATOL)
    _assert_state(model, params, ViTConfig(**SMALL))


@pytest.mark.parametrize("side", ["below", "above"])
def test_clip_matches_optax(side):
    """optax's rule at norms just below and just above ``max_norm``: kept
    below, scaled by max_norm / norm at and above (no ε in the norm)."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(7, 5), rng.randn(11), rng.randn(3, 2, 4)]
    norm = float(np.sqrt(sum((g * g).sum() for g in grads)))
    max_norm = norm * (1 + 1e-9 if side == "below" else 1 - 1e-9)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    ps = [torch.zeros(g.shape, dtype=torch.float64, requires_grad=True)
          for g in grads]
    for p, g in zip(ps, grads):
        p.grad = torch.tensor(g)
    got_norm = ttrain.clip_by_global_norm(ps, max_norm)
    np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-15)
    for p, w, g in zip(ps, want, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   rtol=1e-15, atol=0)
        assert np.array_equal(p.grad.numpy(), g) == (side == "below")


@pytest.mark.parametrize("mode", ["bfloat16", "tensorfloat32"])
@pytest.mark.parametrize("operands", ["weight", "activations"])
def test_moded_product_and_its_gradients_are_kdot(mode, operands):
    """A reduced-precision product under autograd is ``kdot`` in float64
    forward and in both products of its gradient, each rounding its own
    operands (JAX's ``default_matmul_precision`` covers the transposed
    dots)."""
    rng = np.random.RandomState(1)
    a = torch.tensor(rng.randn(3, 5, 8), requires_grad=True)
    if operands == "weight":
        b = torch.tensor(rng.randn(8, 6), requires_grad=True)
    else:
        b = torch.tensor(rng.randn(3, 8, 6), requires_grad=True)
    g = torch.tensor(rng.randn(3, 5, 6))
    out = prec.pmatmul(a, b, mode)
    ga, gb = torch.autograd.grad(out, (a, b), g)
    with torch.no_grad():
        assert torch.equal(out, prec.kdot(a, b, mode))
        assert torch.equal(ga, prec.kdot(g, b.mT, mode))
        if operands == "weight":
            want = prec.kdot(a.reshape(-1, 8).mT, g.reshape(-1, 6), mode)
        else:
            want = prec.kdot(a.mT, g, mode)
        assert torch.equal(gb, want)
        assert not torch.equal(out, a @ b)          # the mode rounds


def test_train_forward_products_follow_the_precision(monkeypatch):
    """``train_forward`` at ``bfloat16`` sends every product but the patch
    embedding through the moded product (six a block and the head), and
    at ``float32`` equals the explain path's logits."""
    _, _, model = _weights()
    imgs = torch.tensor(_batches(1)[0][0])
    calls = []
    real = prec.pmatmul

    def spy(a, b, mode):
        calls.append(mode)
        return real(a, b, mode)

    monkeypatch.setattr(prec, "pmatmul", spy)
    bf = tvit.train_forward(model, imgs, "bfloat16")
    assert calls == ["bfloat16"] * (6 * SMALL["depth"] + 1)
    f32 = tvit.train_forward(model, imgs, "float32")
    np.testing.assert_allclose(f32.detach().numpy(), model(imgs).numpy(),
                               rtol=1e-12, atol=1e-14)
    diff = (bf - f32).abs().max().item()
    assert 0 < diff < 1e-2
    with pytest.raises(ValueError):
        tvit.train_forward(model, imgs, "float16")


def test_train_step_gradients_match_jax_autodiff():
    """The step's loss gradients (autograd through ``train_forward``) equal
    JAX's ``value_and_grad`` of the trainer's loss."""
    jcfg, params, model = _weights()
    imgs, labels = _batches(1)[0]

    def loss(p):
        logits = jax.vmap(lambda im: jvit.forward(p, im, jcfg))(
            jnp.asarray(imgs))
        return jtrain.cross_entropy(logits, jnp.asarray(labels))

    jl, jg = jax.value_and_grad(loss)(params)
    tl = ttrain.cross_entropy(tvit.train_forward(model, torch.tensor(imgs)),
                              torch.tensor(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    cfg = ViTConfig(**SMALL)
    want = vit_params_from_jax(jax.tree.map(np.asarray, jg), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_mesh_raises_naming_a8():
    cfg = ViTConfig(**SMALL)
    opt = ttrain.make_optimizer()
    with pytest.raises(NotImplementedError, match="ROADMAP A8, parallel "
                                                  "paths"):
        ttrain.make_train_step(cfg, opt, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A8, parallel "
                                                  "paths"):
        ttrain.init_train_state(0, cfg, opt, device="cpu", mesh=object())


def test_init_train_state_is_the_seeded_model_and_defaults_to_the_card():
    cfg = ViTConfig(**SMALL)
    opt = ttrain.make_optimizer(lr=3e-4, weight_decay=0.1)
    model, state = ttrain.init_train_state(3, cfg, opt, device="cpu")
    want = tvit.init_params(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert isinstance(state, torch.optim.AdamW)
    assert state.param_groups[0]["lr"] == 3e-4
    assert state.param_groups[0]["weight_decay"] == 0.1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.init_train_state(0, cfg, opt)


def test_train_state_round_trip_is_bitwise(tmp_path):
    """Restore, then one step, is bitwise one uninterrupted step."""
    cfg = ViTConfig(**SMALL)
    opt = ttrain.make_optimizer(lr=1e-3, weight_decay=0.01,
                                max_grad_norm=0.5)
    step = ttrain.make_train_step(cfg, opt, matmul_precision="bfloat16")
    (x1, y1), (x2, y2) = _batches(2, fields=SMALL)
    model, state = ttrain.init_train_state(0, cfg, opt, device="cpu")
    step(model, state, x1, y1)
    prefix = str(tmp_path / "ckpt")
    assert not has_train_state(prefix)
    save_train_state(prefix, model, state, {"epoch": 1})
    assert has_train_state(prefix)
    with np.load(prefix + ".opt.npz") as f:
        names = set(f.files)
    assert {"param_groups", "state.0.step", "state.0.exp_avg",
            "state.0.exp_avg_sq"} <= names
    _, _, loss = step(model, state, x2, y2)

    model2, state2 = ttrain.init_train_state(1, cfg, opt, device="cpu")
    params, opt_sd, meta = restore_train_state(prefix, model2, state2)
    assert meta == {"epoch": 1}
    model2.load_state_dict(params)
    state2.load_state_dict(opt_sd)
    _, _, loss2 = step(model2, state2, x2, y2)
    assert torch.equal(loss, loss2)
    for (k, v), (k2, v2) in zip(model.state_dict().items(),
                                model2.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    for p, p2 in zip(state.state.values(), state2.state.values()):
        for name in p:
            assert torch.equal(p[name], p2[name]), name
    # a template whose parameter groups differ is refused
    other = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))])
    with pytest.raises(ValueError, match="parameter groups"):
        restore_train_state(prefix, model2, other)
    with open(prefix + ".meta.json") as f:
        assert json.load(f) == {"epoch": 1}


def test_batching_matches_jax():
    assert [tbatching.bucket_size(n) for n in range(0, 20)] == \
        [jbatching.bucket_size(n) for n in range(0, 20)]
    a = np.arange(12.0).reshape(3, 4)
    for target in (3, 4, 8):
        np.testing.assert_array_equal(
            tbatching.pad_axis0(torch.tensor(a), target).numpy(),
            np.asarray(jbatching.pad_axis0(a, target)))
    with pytest.raises(ValueError):
        tbatching.pad_axis0(a, 2)


def test_create_model_draws_on_a_cpu_generator(monkeypatch):
    """C7: ``create_model(seed=s)`` draws its weights on a CPU generator
    whatever the device asked for, so a seed is one model everywhere."""
    seen = []
    real = tvit.init_params

    def spy(cfg, *, generator, device, dtype=torch.float32):
        seen.append((generator.device.type, torch.device(device).type))
        return real(cfg, generator=generator, device="cpu", dtype=dtype)

    monkeypatch.setattr(tvit, "init_params", spy)
    monkeypatch.setattr(registry, "_resolve_device", torch.device)
    tiny = dict(depth=1, embed_dim=32, num_heads=2, img_size=32,
                num_classes=3)
    _, sd = registry.create_model("vit_base_patch16_224", seed=5,
                                  device="cuda", **tiny)
    assert seen == [("cpu", "cuda")]
    want = real(dataclasses.replace(tvit.VIT_BASE_16_224, **tiny),
                generator=torch.Generator().manual_seed(5), device="cpu")
    for k in want:
        assert torch.equal(sd[k], want[k]), k


def test_adapt_pretrained_draws_its_head_on_a_cpu_generator(monkeypatch):
    """C7: the head that ``adapt_pretrained`` draws anew comes from a CPU
    generator whatever the weights' device, and is then moved there."""
    made = []
    real = torch.Generator

    def recording(*args, **kw):
        g = real(*args, **kw)
        made.append(g.device.type)
        return g

    w = torch.empty(1000, 16, device="meta")
    monkeypatch.setattr(torch, "Generator", recording)
    new, bias = convert.adapt_classifier(w, torch.empty(1000, device="meta"),
                                         7, 1000)
    monkeypatch.undo()
    assert made == ["cpu"] and new.device.type == "meta"
    assert new.shape == (7, 16) and bias.device.type == "meta"
    cpu, _ = convert.adapt_classifier(torch.zeros(1000, 16),
                                      torch.zeros(1000), 7, 1000)
    want = torch.nn.init.trunc_normal_(
        torch.empty(7, 16), std=0.02, a=-0.04, b=0.04,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(cpu, want)


def test_training_modules_need_no_jax_sklearn_or_transformers(tmp_path):
    """In a fresh process where JAX, scikit-learn and transformers fail to
    import (the card's machine has neither of the last two), the new
    modules import and the trainer, a train-state round trip and the
    hard-rationale scores run on the CPU."""
    import subprocess
    import sys
    import textwrap
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "sklearn", "transformers", "optax"):
            sys.modules[name] = None            # any import of it now fails
        import numpy as np, torch
        from transformer_explainability_torch import train
        from transformer_explainability_torch.models.vit import ViTConfig
        from transformer_explainability_torch.rationale import (
            data, metrics, pipeline, render)
        from transformer_explainability_torch.utils import (
            batching, checkpoint, saver, summaries)
        cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=16, depth=1,
                        num_heads=2, num_classes=3)
        opt = train.make_optimizer()
        model, state = train.init_train_state(0, cfg, opt, device="cpu")
        step = train.make_train_step(cfg, opt)
        x = np.random.RandomState(0).randn(2, 3, 32, 32)
        _, _, loss = step(model, state, x, [0, 2])
        assert torch.isfinite(loss)
        checkpoint.save_train_state("ck", model, state)
        assert checkpoint.has_train_state("ck")
        truth = metrics.Rationale("a", "d", 0, 4).to_token_level()
        pred = metrics.Rationale("a", "d", 2, 6).to_token_level()
        s = metrics.score_hard_rationale_predictions(truth, pred)
        assert abs(s["instance_micro"]["f1"] - 0.5) < 1e-12
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
