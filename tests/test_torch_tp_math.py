"""The tensor-parallel pieces of the port against the JAX package, on the CPU.

Plain versions of the TP MLP kernels B10a/B10b and the product modes of the
attention kernels B4/B5 against the JAX Pallas kernels in interpret mode
(float64, x64 on, numpy-seeded inputs), the two-phase composition over
simulated shards against the one-shot MLP reverse, and the parameter
reshuffle and sharding against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_tpu.parallel.tensor import (
    tp_reshuffle_params as jax_tp_reshuffle)
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as P
from transformer_explainability_torch.ops import relprop as rp
from transformer_explainability_torch.ops import tp_math
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)
from transformer_explainability_torch.parallel import (
    tp_reshuffle_params, tp_shard)

B, N, D, M, EPS = 2, 23, 16, 40, 1e-6
# (mlp mode, rule mode) of the production / bfloat16 presets and exact
MLP_MODES = [("bfloat16", "bfloat16"), ("tensorfloat32", "bfloat16"),
             ("float32", "float32")]
SMALL = dict(img_size=32, patch_size=16, embed_dim=24, depth=3, num_heads=4,
             num_classes=10)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9,
                               atol=1e-12, err_msg=msg)


def _mlp_arrays(seed):
    rng = np.random.RandomState(seed)
    return dict(x_mid=rng.randn(B, N, D) + 0.3, g_out=rng.randn(B, N, D),
                R=rng.randn(B, N, D), s=1 + 0.1 * rng.randn(D),
                b=0.1 * rng.randn(D), w1=rng.randn(D, M) * 0.2,
                w2=rng.randn(M, D) * 0.2, b1=0.1 * rng.randn(M),
                b2=0.1 * rng.randn(D))


def _shard(a, k, c):
    """Shard c of k in the JAX kernel layout: w1 (D, M/k), w2 (M/k, D)."""
    C = M // k
    return a["w1"][:, c * C:(c + 1) * C], a["w2"][c * C:(c + 1) * C], \
        a["b1"][c * C:(c + 1) * C]


def _port_weight(w_kernel_layout, mode):
    """A JAX (in, out) kernel slice as the port's nn.Linear-layout weight,
    prepared for ``mode`` (kept as a tensor for float32)."""
    t = torch.from_numpy(np.ascontiguousarray(w_kernel_layout.T))
    return t if mode == "float32" else P.prepare_weight(t, mode)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("modes", MLP_MODES)
def test_mlp_rev_tp_phases_plain_match_jax_interpret(x64, modes, k):
    mlp, rule = modes
    a = _mlp_arrays(1)
    t = torch.from_numpy
    ln = {"scale": jnp.asarray(a["s"]), "bias": jnp.asarray(a["b"])}
    fc2_pre = axw2 = 0.0
    p1 = []
    for c in range(k):
        w1, w2, b1 = _shard(a, k, c)
        pw1, pw2 = _port_weight(w1, mlp), _port_weight(w2, mlp)
        got = tp_math.mlp_rev_tp_phase1_plain(
            t(a["x_mid"]), t(a["g_out"]), t(a["s"]), t(a["b"]), t(b1), pw1,
            pw2, EPS, mlp, rule)
        for i in range(B):
            want = pk.mlp_rev_tp_phase1(
                jnp.asarray(a["x_mid"][i]), jnp.asarray(a["g_out"][i]), ln,
                jnp.asarray(b1), jnp.asarray(w1), jnp.asarray(w2), EPS,
                mxu=mlp, rule_mxu=rule, use_pallas=True, interpret=True)
            for name, g, w in zip(["fc1_pre", "fc2_pre", "axw2", "g_xn2"],
                                  got, want):
                _close(g[i], w, f"phase 1 {name}, shard {c}, sample {i}")
        p1.append(got)
        fc2_pre, axw2 = fc2_pre + got[1], axw2 + got[2]
    Sr = rp.safe_divide(t(a["R"]), 0.5 * (fc2_pre + axw2))
    for c in range(k):
        w1, w2, b1 = _shard(a, k, c)
        got = tp_math.mlp_rev_tp_phase2_plain(
            t(a["x_mid"]), Sr, p1[c][0], t(a["s"]), t(a["b"]), t(b1),
            _port_weight(w1, mlp), _port_weight(w2, mlp), EPS, rule)
        for i in range(B):
            want = pk.mlp_rev_tp_phase2(
                jnp.asarray(a["x_mid"][i]), jnp.asarray(Sr[i].numpy()),
                jnp.asarray(p1[c][0][i].numpy()), ln, jnp.asarray(b1),
                jnp.asarray(w1), jnp.asarray(w2), EPS, mxu=mlp,
                rule_mxu=rule, use_pallas=True, interpret=True)
            for name, g, w in zip(["num_w", "num_a"], got, want):
                _close(g[i], w, f"phase 2 {name}, shard {c}, sample {i}")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_two_phase_composition_equals_one_shot_mlp_rev(k):
    """Phase 1, host sums, the shared glue, phase 2, host sums, the clone ==
    the one-shot MLP reverse (float32 mode, float64): the same math
    re-associated (tests/test_pallas_kernels.py does this for the JAX
    kernels)."""
    a = _mlp_arrays(2)
    t = torch.from_numpy
    x_mid, g_out, R = t(a["x_mid"]), t(a["g_out"]), t(a["R"])
    s, b = t(a["s"]), t(a["b"])
    shards = [_shard(a, k, c) for c in range(k)]
    p1 = [tp_math.mlp_rev_tp_phase1_plain(
        x_mid, g_out, s, b, t(b1), _port_weight(w1, "float32"),
        _port_weight(w2, "float32"), EPS, "float32", "float32")
        for w1, w2, b1 in shards]
    fc2_pre, axw2, g_xn2 = (sum(p[j] for p in p1) for j in (1, 2, 3))
    R1, R2 = rp.add_relprop(x_mid, fc2_pre + t(a["b2"]), R)
    Sr = rp.safe_divide(R2, 0.5 * (fc2_pre + axw2))
    p2 = [tp_math.mlp_rev_tp_phase2_plain(
        x_mid, Sr, p[0], s, b, t(b1), _port_weight(w1, "float32"),
        _port_weight(w2, "float32"), EPS, "float32")
        for p, (w1, w2, b1) in zip(p1, shards)]
    num_w, num_a = (sum(p[j] for p in p2) for j in (0, 1))
    xn2, mu, inv = bm.ln_fwd(x_mid, s, b, EPS)
    Rm = rp.clone_relprop(x_mid, [R1, 0.5 * (xn2 * num_w
                                             + xn2.abs() * num_a)])
    g_mid = g_out + bm.ln_bwd(g_xn2, x_mid, mu, inv, s)
    z = torch.zeros(D, dtype=torch.float64)
    p = bm.BlockParams(z, z, s, b, z, z, t(a["b1"]), t(a["b2"]), None, None,
                       t(np.ascontiguousarray(a["w1"].T)),
                       t(np.ascontiguousarray(a["w2"].T)))
    want_g, want_R = bm.mlp_rev_math(x_mid, g_out, R, p, eps=EPS,
                                     mxu="float32", rule_mxu="float32")
    torch.testing.assert_close(g_mid, want_g, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(Rm, want_R, rtol=1e-9, atol=1e-12)


H, HD = 3, 8


@pytest.mark.parametrize("mxu", ["bfloat16", "float32"])
def test_attn_fwd_modes_match_jax_interpret(x64, mxu):
    qkv = np.random.RandomState(3).randn(B, N, 3 * H * HD)
    got = K.attn_fwd_core(torch.from_numpy(qkv), H, HD, HD ** -0.5, mxu=mxu)
    for i in range(B):
        want = pk.attn_fwd_core(jnp.asarray(qkv[i]), H, HD, HD ** -0.5,
                                mxu=mxu, use_pallas=True, interpret=True)
        _close(got[i], want, f"sample {i}")


@pytest.mark.parametrize("modes", [("float32", "bfloat16"),
                                   ("bfloat16", "bfloat16"),
                                   ("float32", "float32")])
def test_attn_rev_modes_match_jax_interpret(x64, modes):
    attn, rule = modes
    rng = np.random.RandomState(4)
    qkv = rng.randn(B, N, 3 * H * HD) + 1.0
    g_o, cam_o = rng.randn(B, N, H * HD), rng.randn(B, N, H * HD)
    got = K.attn_rev_core(*map(torch.from_numpy, (qkv, g_o, cam_o)), H, HD,
                          HD ** -0.5, attn_mxu=attn, rule_mxu=rule)
    for i in range(B):
        want = pk.attn_rev_core(jnp.asarray(qkv[i]), jnp.asarray(g_o[i]),
                                jnp.asarray(cam_o[i]), H, HD, HD ** -0.5,
                                attn_mxu=attn, rule_mxu=rule,
                                use_pallas=True, interpret=True)
        for name, g, w in zip(["g_qkv", "cam_qkv", "gc"], got, want):
            _close(g[i], w, f"{name}, sample {i}")


def _jax_and_port_params(key=0):
    jcfg = jvit.ViTConfig(**SMALL)
    tree = jax.tree.map(np.asarray,
                        jvit.init_params(jax.random.PRNGKey(key), jcfg))
    return tree, vit_params_from_jax(tree, ViTConfig(**SMALL))


def test_tp_reshuffle_roundtrip():
    """The reshuffled qkv rows, taken shard by shard, are each shard's
    heads' q/k/v groups (tests/test_parallel_tp.py for the JAX layout)."""
    _, sd = _jax_and_port_params(1)
    cfg, k = ViTConfig(**SMALL), 2
    h, d, Dm = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    resh = tp_reshuffle_params(sd, k)
    for i in range(cfg.depth):
        w = sd[f"blocks.{i}.attn.qkv.weight"].reshape(3, h, d, Dm)
        wr = resh[f"blocks.{i}.attn.qkv.weight"].reshape(k, 3, h // k, d, Dm)
        for j in range(k):
            for q in range(3):
                torch.testing.assert_close(
                    wr[j, q], w[q, j * (h // k):(j + 1) * (h // k)],
                    rtol=0, atol=0)
        assert resh["blocks.0.mlp.fc1.weight"] is sd["blocks.0.mlp.fc1.weight"]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_shards_equal_jax_reshuffled_slices_bitwise(k):
    """tp_shard of the converted weights == the slices JAX's
    tp_reshuffle_params + tp_param_specs give each rank, bit for bit."""
    tree, sd = _jax_and_port_params()
    cfg = ViTConfig(**SMALL)
    D3, Dm, Mm = 3 * cfg.embed_dim, cfg.embed_dim, cfg.mlp_dim
    blk = jax.tree.map(np.asarray, jax_tp_reshuffle(tree, k))["blocks"]
    for r in range(k):
        p = tp_shard(sd, cfg, k, r)
        assert (p.k, p.rank, p.mode) == (k, r, "float32")
        for i, b in enumerate(p.blocks):
            q, c, m = (slice(r * x // k, (r + 1) * x // k)
                       for x in (D3, Dm, Mm))
            pairs = [
                (b.wqkv, blk["qkv"]["kernel"][i][:, q].T),
                (b.bqkv, blk["qkv"]["bias"][i][q]),
                (b.wproj, blk["proj"]["kernel"][i][c].T),
                (b.bproj, blk["proj"]["bias"][i]),
                (b.w1, blk["fc1"]["kernel"][i][:, m].T),
                (b.b1, blk["fc1"]["bias"][i][m]),
                (b.w2, blk["fc2"]["kernel"][i][m].T),
                (b.b2, blk["fc2"]["bias"][i]),
                (b.ln1s, blk["norm1"]["scale"][i]),
                (b.ln2b, blk["norm2"]["bias"][i])]
            for j, (got, want) in enumerate(pairs):
                assert got.is_contiguous()
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"rank {r} block {i} "
                                                      f"entry {j}")
        prepared = tp_shard(sd, cfg, k, r, "tensorfloat32").blocks[0].w1
        for u, v in zip(prepared, P.prepare_weight(p.blocks[0].w1,
                                                   "tensorfloat32")):
            assert torch.equal(u, v)


def test_shard_rejects_a_width_the_group_does_not_divide():
    _, sd = _jax_and_port_params()
    with pytest.raises(ValueError, match="divide"):
        tp_shard(sd, ViTConfig(**SMALL), 3, 0)
