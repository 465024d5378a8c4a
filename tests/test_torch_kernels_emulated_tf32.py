"""The CUDA kernel sources themselves, run on the CPU: the bf16×3
(``tensorfloat32``) modes of the attention kernels B4 and B5 and of the ViT
block megakernels B2 and B3, and the modes that predate them, unchanged.

``tests/cuda_emulator`` compiles ``transformer_explainability_torch/csrc/*.cu``
as plain C++ with g++ and the tests call the host launchers the wrappers
call, through ``ctypes``, on CPU tensors. Each new instance is held to its
plain PyTorch version (``kdot``'s bf16×3 split): float64 at rtol 1e-9 /
atol 1e-12, float32 by the rule of ``tests/torch_emulator_common.py`` (10 ×
the plain float32 version's error plus 1e-6 of the output's magnitude),
B5's and B3's reverse outputs against the plain float32 version's draws on
ulp-moved inputs (``_f32_drawn``: their safe-divide chains and the bf16
rule products of the mixed pairs make one float32 run a draw); the GEMM
core's promoted bf16×3 mode (the MLP products', fault C5) against ``kdot``
as the core's other modes are held. The pre-bf16×3 modes' outputs, B9's
among them (it shares ``rules.cuh``), are held bitwise to
``tests/golden/torch_emulated_modes.npz``.

Shared helpers and the ``lib`` fixture: ``tests/torch_emulator_common.py``.
"""

import os

import numpy as np
import pytest
import torch

from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as P

from torch_emulator_common import (  # noqa: F401 (lib: a fixture)
    lib, _randn, SHAPES, B5_SHAPES, EPS, TF32_PRESETS, BLOCK_SHAPES,
    BLOCK_TILE_SHAPES, _block_case, _f32_rule, _check_attn_rev,
    _check_block_rev, mode_outputs)

TF32 = "tensorfloat32"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_emulated_modes.npz")
# B5's (attention, rule) pairs with a bf16×3 product: with the four that
# predate them, all nine that the float32 base's islands reach
B5_TF32_PAIRS = [("float32", TF32), ("bfloat16", TF32), (TF32, TF32),
                 (TF32, "float32"), (TF32, "bfloat16")]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_attn_fwd_kernel_tf32_matches_plain(lib, shape, dtype):
    """B4 in bf16×3 (its tiles are held in every mode by
    ``test_attn_fwd_kernel_tiles_match_plain``)."""
    b, n, h, d = shape
    qkv = _randn(45, b, n, 3 * h * d)
    got = K._launch_attn_fwd(lib, qkv.to(dtype), h, d, d ** -0.5, None,
                             K._ATTN_MODE[TF32])
    want = K.attn_fwd_core_plain(qkv, h, d, d ** -0.5, TF32)
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    else:
        _f32_rule(got, K.attn_fwd_core_plain(qkv.float(), h, d, d ** -0.5,
                                             TF32), want, "out")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("pair", B5_TF32_PAIRS, ids="-".join)
def test_attn_rev_kernel_tf32_pairs_match_plain(lib, shape, pair):
    _check_attn_rev(lib, shape, *pair, (46, 47, 48), drawn=True)


# B5's row pass across its tiles in bf16×3 (three query tiles; the
# shared-memory softmax above 256 keys), as the other pairs are held in
# test_attn_rev_kernel_modes_match_plain
@pytest.mark.parametrize("shape", B5_SHAPES[2:])
def test_attn_rev_kernel_tf32_tiles_match_plain(lib, shape):
    _check_attn_rev(lib, shape, TF32, TF32, (46, 47, 48), drawn=True)


@pytest.mark.parametrize("shape", BLOCK_SHAPES + BLOCK_TILE_SHAPES)
@pytest.mark.parametrize("preset", ["tensorfloat32", "bf16-tf32-attn"])
def test_block_fwd_kernel_tf32_matches_plain(lib, shape, preset):
    """B2 with its attention core in bf16×3 (the other presets' attention
    modes are B2's existing instances)."""
    b, n, h, hd = shape
    mxu, attn, _, mlp = TF32_PRESETS[preset]
    p64, p32, x = _block_case(25, b, n, h, hd, mxu)
    flags = K._block_modes("block_fwd_core", p32, mxu=mxu, mlp=mlp or mxu,
                           attn_mode=attn)
    got = K._launch_block_fwd(lib, x.float(), p32, h, hd, EPS, flags, None)
    args = (h, hd, EPS, mxu, attn, mlp, True, True)
    want64 = bm.block_fwd_core_plain(x, p64, *args)
    want32 = bm.block_fwd_core_plain(x.float(), p32, *args)
    names = ["x_out", "x_mid", "out_m", "qkv_pre", "proj_pre", "dots",
             "probs", "fc1_pre", "fc2_pre"]
    for k, p, q, name in zip(got, want32, want64, names):
        assert k.shape == q.shape, name
        _f32_rule(k, p, q, name)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
@pytest.mark.parametrize("preset", sorted(TF32_PRESETS))
def test_block_rev_kernel_tf32_matches_plain(lib, shape, preset):
    _check_block_rev(lib, shape, preset)


@pytest.mark.parametrize("shape", BLOCK_TILE_SHAPES)
def test_block_rev_kernel_tf32_tiles_match_plain(lib, shape):
    _check_block_rev(lib, shape, "tensorfloat32")


def test_attn_rev_probs_are_b2_anchors_in_tf32(lib):
    """B5's P from B2's own qkv is bitwise B2's probs in bf16×3 attention
    too (both form them by B4's tile)."""
    mxu, attn, rule, mlp = TF32_PRESETS["tensorfloat32"]
    b, n, h, hd = 1, 2 * 64 + 5, 2, 64
    _, p32, x = _block_case(26, b, n, h, hd, mxu)
    fwd = K._launch_block_fwd(lib, x.float(), p32, h, hd, EPS, K._block_modes(
        "block_fwd_core", p32, mxu=mxu, mlp=mxu, attn_mode=attn), None)
    qkv = fwd[3] + p32.bqkv
    g_o, cam_o = (_randn(27 + i, b, n, h * hd, dtype=torch.float32)
                  for i in range(2))
    outs = [torch.empty_like(qkv), torch.empty_like(qkv),
            torch.empty(b, n, n)]
    maps = [torch.empty(b, h, n, n) for _ in range(4)]   # P, G, S2, GCP
    S1 = torch.empty(b, h, n, hd)
    code = lib.te_attn_rev_f32(
        *[t.data_ptr() for t in (qkv, g_o, cam_o, *outs, *maps, S1)], b, n,
        h, hd, hd ** -0.5, K._ATTN_MODE[attn], K._ATTN_MODE[rule], None)
    assert code == 0
    assert torch.equal(maps[0].view(torch.int32),
                       fwd[6].reshape(b, h, n, n).view(torch.int32))


# the GEMM core's instances the MLP products take in bf16×3 (the forward
# x·Wᵀ, the backward g·W) and, through the core-alone entry, its rule
# instances, at a ragged row tile, N off the tile width and K over five
# 64-deep k-steps (four promotions), both tiles
@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("instance", [(True, False, False),
                                      (False, False, False),
                                      (True, True, False),
                                      (False, False, True)])
def test_gemm_core_promoted_bf16x3_matches_kdot(lib, instance, tile):
    """The MLP products' bf16×3 mode (``kBf16x3Rn``, mode 2 of the core
    alone: each k-step's three passes summed, then added to the running
    sum with round-to-nearest, fault C5) against ``kdot`` on the same split
    operands in float64, as the core's other instances are held, and no
    further from it than the one-chain mode (1) on these inputs."""
    wt, absolute, dual = instance
    M, N, Kd = 136, 200, 264
    rng = np.random.RandomState(72 + tile)
    a = torch.from_numpy(rng.randn(M, Kd)).float()
    w = P.prepare_weight(torch.from_numpy(
        rng.randn(*((N, Kd) if wt else (Kd, N))) / np.sqrt(Kd)), TF32)
    want = K.gemm_core_plain(a.double(), w, TF32, wt, absolute, dual)
    want = want if dual else (want,)
    wv = sum(t.double() for t in w).abs()
    mag = a.double().abs() @ (wv.t() if wt else wv)
    errs = {}
    for mode in (1, 2):
        got = K._launch_gemm(lib, a, w, mode, wt, absolute, dual, tile, None)
        got = got if dual else (got,)
        errs[mode] = max(((g.double() - q).abs() / mag).max().item()
                         for g, q in zip(got, want))
    assert errs[2] <= Kd * 2.0 ** -24, errs
    assert errs[2] <= errs[1], errs


def test_pre_tf32_modes_are_bitwise_unchanged(lib):
    """B4, B5, B2, B3 and B9 in the modes that predate bf16×3 compute what
    the sources before the bf16×3 instances computed, bit for bit."""
    gold = np.load(GOLDEN)
    got = mode_outputs(lib)
    assert sorted(got) == sorted(gold.files)
    for name, arr in got.items():
        np.testing.assert_array_equal(arr, gold[name], err_msg=name)


def test_c_entries_refuse_modes_they_lack(lib):
    """No C entry takes a mode flag it has no instance for: B7 and B9 no
    bf16×3 attention or rule flag (ROADMAP B, raw tensorfloat32 (BERT)), B3
    no float32 rule flag, B4 and B5 no flag past bf16×3. The workspace
    query is where each entry checks its flags first, with null pointers."""
    import ctypes
    size = ctypes.c_size_t(0)

    def query(fn, dims):
        nulls = [None] * (len(fn.argtypes) - len(dims) - 1)
        nulls[-1] = ctypes.addressof(size)
        return fn(*nulls, *dims, None)

    # (B, S, H, hd, I, eps, mxu, attn, mlp) and (B, S, H, hd, eps, mxu,
    # attn, rule_attn, rule)
    assert query(lib.te_bert_fwd_f32, [1, 8, 1, 8, 16, 1e-12, 0, 1, 0]) == 0
    assert query(lib.te_bert_fwd_f32, [1, 8, 1, 8, 16, 1e-12, 0, 2, 0]) != 0
    assert query(lib.te_bert_attn_rev_f32, [1, 8, 1, 8, 1e-12, 0, 1, 1,
                                            0]) == 0
    for attn, rule in ((2, 1), (0, 2), (2, 2)):
        assert query(lib.te_bert_attn_rev_f32, [1, 8, 1, 8, 1e-12, 0, attn,
                                                rule, 0]) != 0
    # (B, n, H, hd, M, eps, mxu, attn, rule_attn, rule, mlp)
    assert query(lib.te_block_rev_f32, [1, 8, 1, 8, 32, 1e-6, 1, 2, 2, 1,
                                        1]) == 0
    assert query(lib.te_block_rev_f32, [1, 8, 1, 8, 32, 1e-6, 1, 2, 0, 1,
                                        1]) != 0
    qkv = _randn(49, 1, 8, 24, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="attn_fwd_core"):
        K._launch_attn_fwd(lib, qkv, 1, 8, 1.0, None, 3)
    g_o = _randn(50, 1, 8, 8, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="attn_rev_core"):
        K._launch_attn_rev(lib, qkv, g_o, g_o, 1, 8, 1.0, None, 0, 3)
