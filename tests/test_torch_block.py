"""The plain versions of the block megakernels B2 and B3 and their precision
helpers, against the JAX package on the CPU.

Float64 throughout (the JAX side with x64 on), the same numpy-seeded
inputs both ways. The JAX side runs its jnp paths (``use_pallas=False``);
the split helpers are compared bitwise. Tolerance rtol 1e-9 / atol 1e-12:
with the bf16 roundings of ``_kdot`` reproduced exactly, only the
summation order of float64 differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import precision as P

RTOL, ATOL = 1e-9, 1e-12
B, N, H, HD = 2, 13, 3, 8
D, M = H * HD, 4 * H * HD
EPS = 1e-6

# (mxu, attn_mxu, rule_mxu, mlp_mxu) of the presets as the JAX package
# resolves them for the megakernels (vit.forward_collect / reverse_pass)
PRESETS = {
    "production": ("tensorfloat32", "float32", "bfloat16", "bfloat16"),
    "bfloat16": ("bfloat16", "bfloat16", "bfloat16", None),
    # raw tensorfloat32: every product bf16×3
    "tensorfloat32": ("tensorfloat32", "tensorfloat32", "tensorfloat32",
                      None),
    # the bfloat16 base with a tensorfloat32 attention island
    "bf16-tf32-attn": ("bfloat16", "tensorfloat32", "bfloat16", None),
}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def _f32(bf16_array) -> np.ndarray:
    return np.asarray(bf16_array).astype(np.float32)


def _tie_values():
    """float32 values whose low 16 bits sit on and next to the bf16
    rounding ties, both signs, plus random ones."""
    rng = np.random.RandomState(0)
    hi = rng.randint(0x3000, 0x4800, size=64).astype(np.uint32) << 16
    lows = np.array([0x7FFF, 0x8000, 0x8001, 0x0000, 0xFFFF, 0x18000 & 0xFFFF],
                    dtype=np.uint32)
    u = (hi[:, None] | lows[None, :]).reshape(-1)
    u = np.concatenate([u, u | np.uint32(0x80000000)])
    vals = u.view(np.float32)
    return np.concatenate([vals, rng.randn(4096).astype(np.float32)])


def test_split_hi_lo_bitwise_float32(x64):
    x = _tie_values()
    hi, lo = P.split_hi_lo(torch.from_numpy(x))
    jhi, jlo = pk._split_hi_lo(jnp.asarray(x))
    np.testing.assert_array_equal(hi.float().numpy(), _f32(jhi))
    np.testing.assert_array_equal(lo.float().numpy(), _f32(jlo))
    np.testing.assert_array_equal(
        P.bf16_head(torch.from_numpy(x)).numpy(),
        np.asarray(pk._bf16_head_f32(jnp.asarray(x))))


def test_split_hi_lo_bitwise_float64_cast_as_kdot(x64):
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(4096), _tie_values().astype(np.float64)])
    hi, lo = P.split_hi_lo(torch.from_numpy(x))
    jhi, jlo = pk._split_hi_lo(jnp.asarray(x).astype(jnp.float32))
    np.testing.assert_array_equal(hi.float().numpy(), _f32(jhi))
    np.testing.assert_array_equal(lo.float().numpy(), _f32(jlo))
    # the bf16 cast of a float64 operand (one-pass _kdot) rounds through f32
    np.testing.assert_array_equal(
        torch.from_numpy(x).float().to(torch.bfloat16).float().numpy(),
        _f32(jnp.asarray(x).astype(jnp.bfloat16)))


def test_kabs_of_pair_matches_jax(x64):
    w = np.random.RandomState(2).randn(17, 9)
    pair = P.split_hi_lo(torch.from_numpy(w))
    jpair = pk._split_hi_lo(jnp.asarray(w).astype(jnp.float32))
    for got, want in zip(P.kabs(pair), pk._kabs(jpair)):
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("mode,paired", [
    ("bfloat16", False), ("bfloat16", True), ("tensorfloat32", False),
    ("tensorfloat32", True), ("float32", False)])
def test_kdot_matches_jax(x64, mode, paired):
    rng = np.random.RandomState(3)
    a, w = rng.randn(7, 40), rng.randn(40, 11)
    b = (P.prepare_weight(torch.from_numpy(w), mode) if paired
         else torch.from_numpy(w))
    jb = (pk._flatten_weights([jnp.asarray(w)], mode)[0] if paired
          else jnp.asarray(w))
    if paired:
        jb = tuple(jb) if mode == "tensorfloat32" else (jb[0],)
    got = P.kdot(torch.from_numpy(a), b, mode)
    want = pk._kdot(jnp.asarray(a), jb, ((1,), (0,)), mode)
    assert got.dtype == torch.float64
    _close(got, want)


def test_kdot_float32_accumulates_in_float32():
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 3).astype(np.float32))
    for mode in P.MODES:
        assert P.kdot(a, w, mode).dtype == torch.float32
    with pytest.raises(ValueError):
        P.kdot(a, (w.to(torch.bfloat16),), "tensorfloat32")
    with pytest.raises(ValueError):
        P.prepare_weight(w, "float32")


def test_islands_exceed_base_matches_jax():
    names = [None, "bfloat16", "tensorfloat32", "float32"]
    for base in ("bfloat16", "tensorfloat32", "float32"):
        for a in names:
            for b in names:
                assert (P.islands_exceed_base(base, a, b)
                        == pk.islands_exceed_base(base, a, b))


# ---------------------------------------------------------------------------
# B2 / B3 plain versions
# ---------------------------------------------------------------------------

def _block_arrays(seed):
    """One block's parameters (JAX layout: Linear kernels (in, out))."""
    rng = np.random.RandomState(seed)

    def lin(i, o):
        return {"kernel": rng.randn(i, o) / np.sqrt(i),
                "bias": 0.1 * rng.randn(o)}

    def ln():
        return {"scale": 1.0 + 0.1 * rng.randn(D), "bias": 0.1 * rng.randn(D)}

    return {"norm1": ln(), "qkv": lin(D, 3 * D), "proj": lin(D, D),
            "norm2": ln(), "fc1": lin(D, M), "fc2": lin(M, D)}


def _jax_bp(arrs):
    return jax.tree.map(jnp.asarray, arrs)


def _port_params(arrs, base):
    t = lambda a: torch.from_numpy(np.asarray(a))
    w = lambda name: P.prepare_weight(t(arrs[name]["kernel"].T), base)
    return bm.BlockParams(
        t(arrs["norm1"]["scale"]), t(arrs["norm1"]["bias"]),
        t(arrs["norm2"]["scale"]), t(arrs["norm2"]["bias"]),
        t(arrs["qkv"]["bias"]), t(arrs["proj"]["bias"]),
        t(arrs["fc1"]["bias"]), t(arrs["fc2"]["bias"]),
        w("qkv"), w("proj"), w("fc1"), w("fc2"))


def _x(seed):
    return np.random.RandomState(seed).randn(B, N, D) + 0.5


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("save", [(False, False), (True, False), (True, True)])
def test_block_fwd_core_plain_matches_jax(x64, preset, save):
    mxu, attn_mxu, _, mlp_mxu = PRESETS[preset]
    arrs, x = _block_arrays(10), _x(11)
    got = bm.block_fwd_core_plain(torch.from_numpy(x), _port_params(arrs, mxu),
                                  H, HD, EPS, mxu, attn_mxu, mlp_mxu,
                                  save_attn=save[0], save_mlp=save[1])
    assert len(got) == 3 + 4 * save[0] + 2 * save[1]
    for i in range(B):
        want = pk.block_fwd_core(
            jnp.asarray(x[i]), _jax_bp(arrs), H, HD, EPS, mxu=mxu,
            attn_mxu=attn_mxu, mlp_mxu=mlp_mxu, use_pallas=False,
            save_attn=save[0], save_mlp=save[1])
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g[i], w, f"output {k}, sample {i}")


def _rev_inputs(arrs, mxu, attn_mxu, mlp_mxu):
    """Forward anchors from the JAX forward itself (a consistent family),
    plus random cotangent and relevance."""
    x = _x(12)
    rng = np.random.RandomState(13)
    g_out, R = rng.randn(B, N, D), rng.randn(B, N, D)
    fwd = [pk.block_fwd_core(jnp.asarray(x[i]), _jax_bp(arrs), H, HD, EPS,
                             mxu=mxu, attn_mxu=attn_mxu, mlp_mxu=mlp_mxu,
                             use_pallas=False, save_attn=True, save_mlp=True)
           for i in range(B)]
    stack = [np.stack([np.asarray(f[k]) for f in fwd]) for k in range(9)]
    return x, stack[1], stack[2], g_out, R, tuple(stack[3:])


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("form", ["saved6", "recompute"])
def test_block_rev_core_plain_matches_jax(x64, preset, form):
    mxu, attn_mxu, rule_mxu, mlp_mxu = PRESETS[preset]
    arrs = _block_arrays(14)
    x_in, x_mid, out_m, g_out, R, saved = _rev_inputs(arrs, mxu, attn_mxu,
                                                       mlp_mxu)
    use = saved if form == "saved6" else None
    t = torch.from_numpy
    got = bm.block_rev_core_plain(
        t(x_in), t(x_mid), t(out_m), t(g_out), t(R), _port_params(arrs, mxu),
        H, HD, EPS, mxu, attn_mxu, rule_mxu, mlp_mxu,
        saved=None if use is None else tuple(t(s) for s in use))
    for i in range(B):
        want = pk.block_rev_core(
            jnp.asarray(x_in[i]), jnp.asarray(x_mid[i]), jnp.asarray(out_m[i]),
            jnp.asarray(g_out[i]), jnp.asarray(R[i]), _jax_bp(arrs), H, HD,
            EPS, mxu=mxu, attn_mxu=attn_mxu, rule_mxu=rule_mxu,
            mlp_mxu=mlp_mxu, use_pallas=False,
            saved=None if use is None else tuple(jnp.asarray(s[i])
                                                 for s in use))
        for g, w, name in zip(got, want, ["g_in", "R_in", "gc"]):
            _close(g[i], w, f"{name}, sample {i}")


def test_block_rev_saved_equals_recompute_at_float64():
    """With consistent anchors the saved form computes what the recompute
    form does (the anchors are the recompute's own values)."""
    mxu, attn_mxu, rule_mxu, mlp_mxu = PRESETS["production"]
    arrs = _block_arrays(15)
    p = _port_params(arrs, mxu)
    x = torch.from_numpy(_x(16))
    outs = bm.block_fwd_core_plain(x, p, H, HD, EPS, mxu, attn_mxu, mlp_mxu,
                                   save_attn=True, save_mlp=True)
    rng = np.random.RandomState(17)
    g_out, R = (torch.from_numpy(rng.randn(B, N, D)) for _ in range(2))
    args = (x, outs[1], outs[2], g_out, R, p, H, HD, EPS, mxu, attn_mxu,
            rule_mxu, mlp_mxu)
    a = bm.block_rev_core_plain(*args, saved=outs[3:])
    b = bm.block_rev_core_plain(*args, saved=None)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-9, atol=1e-12)
