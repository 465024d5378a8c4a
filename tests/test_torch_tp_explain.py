"""The port's tensor-parallel ViT explain program against the JAX package.

The port runs in k gloo processes (``torch.multiprocessing``, start method
``spawn``, a ``FileStore`` under the test's temporary directory, one
thread per rank; the rank program is ``tests/torch_tp_worker.py``); the
JAX package's ``make_tp_explain_fn`` runs on ``make_mesh(n_data=1,
n_model=k)`` over the virtual CPU devices of ``tests/conftest.py``. Same
weights both ways (JAX ``init_params`` exported with the port's
converter), same numpy inputs, float64. JAX on the CPU runs every product
exactly whatever the precision names, as the port's ``float32`` preset
does: rtol 1e-8, atol 1e-12, as for the single-device slice. The
``production`` and ``bfloat16`` presets are held to the port's own k = 1
run at the same tolerance (sharding only re-associates float64 sums).

Each job joins its ranks under a deadline of 120 s and kills them when it
passes, so that a hung rendezvous fails one test instead of the suite.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_tp_worker
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.parallel.mesh import make_mesh
from transformer_explainability_tpu.parallel.tensor import (
    make_tp_explain_fn as jax_make_tp_explain_fn)
from transformer_explainability_torch.explain.generator import (
    precision_kwargs)
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)
from transformer_explainability_torch.parallel import make_tp_explain_fn

SMALL = dict(img_size=32, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)
WIDE = dict(depth=2)                      # ViT-B/16 widths, two blocks
DEADLINE = 120.0
RTOL, ATOL = 1e-8, 1e-12
PRESETS = ["production", "bfloat16"]


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
    return tree64, vit_params_from_jax(tree64, ViTConfig(**fields))


def _run_ranks(workdir, k, job):
    """Run ``job`` on k spawned gloo ranks; returns each rank's results.
    Fails (and kills the ranks) when they are not done by the deadline."""
    job_path = workdir / "job.pt"
    torch.save(job, job_path)
    out = str(workdir / "out{}.pt")
    ctx = mp.start_processes(
        torch_tp_worker.run_rank,
        args=(k, str(workdir / "store"), str(job_path), out), nprocs=k,
        join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=max(0.0, end - time.monotonic())):
            if time.monotonic() >= end:
                pytest.fail(f"{k} ranks did not finish in {DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out.format(r), weights_only=False) for r in range(k)]


def _small_runs(k):
    runs = {"f32-kernel": {"kw": {"mlp_kernel": True}},
            "f32-plain": {"kw": {"mlp_kernel": False}},
            "f32-rich": {"kw": {"rich_anchors": True}},
            "mesh": {"mesh": True}}
    runs.update({p: {"kw": precision_kwargs(p)} for p in PRESETS})
    if k == 2:
        runs.update({
            "gate-heads": {"cfg": dict(SMALL, num_heads=3)},
            "gate-variant": {"kw": {"variant": "lrp"}},
            "gate-alpha": {"kw": {"alpha": 2.0}},
            "gate-method": {"kw": {"method": "rollout"}},
            "gate-tf32": {"kw": {"matmul_precision": "tensorfloat32"}}})
    return runs


@pytest.fixture(scope="module")
def small():
    tree, sd = _weights(SMALL)
    rng = np.random.RandomState(7)
    imgs, idx = rng.randn(4, 3, 32, 32), np.array([3, -1, 0, 9])
    return tree, sd, imgs, idx


@pytest.fixture(scope="module")
def ranks(small, tmp_path_factory):
    """k -> every rank's results of the SMALL job (run once per k)."""
    _, sd, imgs, idx = small
    cache = {}

    def get(k):
        if k not in cache:
            job = dict(cfg=SMALL, params=sd, images=torch.from_numpy(imgs),
                       indices=torch.from_numpy(idx), runs=_small_runs(k))
            cache[k] = _run_ranks(tmp_path_factory.mktemp(f"tp{k}"), k, job)
        return cache[k]
    return get


def _jax_tp(tree, fields, imgs, idx, k, **kw):
    fn = jax_make_tp_explain_fn(jvit.ViTConfig(**fields),
                                make_mesh(n_data=1, n_model=k), **kw)
    return np.asarray(fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs),
                         jnp.asarray(idx, jnp.int32)))


@pytest.mark.parametrize("mlp_kernel", [True, False])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_tp_matches_jax_f64(x64, small, ranks, k, mlp_kernel):
    tree, _, imgs, idx = small
    got = ranks(k)[0]["f32-kernel" if mlp_kernel else "f32-plain"]
    assert got.shape == (4, 4) and got.dtype == torch.float64
    want = _jax_tp(tree, SMALL, imgs, idx, k, mlp_kernel=mlp_kernel)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_tp_rich_anchors_match_jax_f64(x64, small, ranks):
    tree, _, imgs, idx = small
    want = _jax_tp(tree, SMALL, imgs, idx, 2, rich_anchors=True)
    np.testing.assert_allclose(ranks(2)[0]["f32-rich"].numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_tp_vit_b_width_two_blocks_matches_jax_f64(x64, tmp_path):
    """ViT-B/16 widths (D=768, h=12, n=197, M=3072) at depth 2, k = 2."""
    tree, sd = _weights(WIDE)
    imgs = np.random.RandomState(2).randn(2, 3, 224, 224)
    idx = np.array([17, -1])
    job = dict(cfg=WIDE, params=sd, images=torch.from_numpy(imgs),
               indices=torch.from_numpy(idx), runs={"f32": {}})
    got = _run_ranks(tmp_path, 2, job)[0]["f32"]
    assert got.shape == (2, 196)
    want = _jax_tp(tree, WIDE, imgs, idx, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("preset", PRESETS)
def test_tp_presets_at_k_equal_k1(ranks, preset, k):
    got, want = ranks(k)[0][preset], ranks(1)[0][preset]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_every_rank_gets_the_same_heatmaps(ranks, k):
    results = ranks(k)
    for r in range(1, k):
        for name, want in results[0].items():
            got = results[r][name]
            if torch.is_tensor(want):
                assert torch.equal(got, want), (r, name)
            else:
                assert got == want, (r, name)


def test_mesh_routes_a_multi_rank_group_to_tp(ranks):
    res = ranks(2)[0]
    assert torch.equal(res["mesh"], res["f32-plain"])


@pytest.mark.parametrize("k,run,error,match", [
    (2, "gate-heads", "ValueError", "divide"),
    (2, "gate-variant", "NotImplementedError",
     "ROADMAP A8, parallel paths"),
    (2, "gate-alpha", "NotImplementedError",
     "ROADMAP A8, parallel paths"),
    (2, "gate-method", "NotImplementedError",
     "ROADMAP A8, parallel paths"),
    (2, "gate-tf32", "NotImplementedError", "ROADMAP B"),
    (1, "mesh", "NotImplementedError", "ROADMAP A8, parallel paths"),
])
def test_gates_raise(ranks, k, run, error, match):
    got = ranks(k)[0][run]
    assert isinstance(got, tuple) and got[0] == error, got
    assert match in got[1], got


def test_tp_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_tp_explain_fn(ViTConfig(**SMALL), device="cpu")


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("preset,mlp_kernel,b10", [
    ("production", None, True), ("bfloat16", None, True),
    ("float32", None, False), ("float32", True, True)])
def test_tp_takes_the_kernels(one_rank_group, small, preset, mlp_kernel,
                              b10):
    """Per batch: B4 and B5 once per block on the local heads, B10a/B10b
    once per block where the MLP kernel arm runs, B1 once (plain versions
    on the CPU, called through the ops table)."""
    _, sd, imgs, idx = small
    calls = {}

    def counted(name, f):
        def g(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return f(*a, **kw)
        return g

    ops = K.AttnOps(*(counted(n, f) for n, f in K.PLAIN_OPS._asdict()
                      .items()))
    fn = make_tp_explain_fn(ViTConfig(**SMALL), device="cpu", ops=ops,
                            mlp_kernel=mlp_kernel, **precision_kwargs(preset))
    heat = fn(sd, imgs, idx)
    assert heat.shape == (4, 4) and torch.isfinite(heat).all()
    L = SMALL["depth"]
    want = {"attn_fwd_core": L, "attn_rev_core": L,
            "rollout_from_grad_cam": 1}
    if b10:
        want.update(mlp_rev_tp_phase1=L, mlp_rev_tp_phase2=L)
    assert calls == want
