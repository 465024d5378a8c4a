"""The CUDA kernel sources themselves, run on the CPU.

``tests/cuda_emulator`` compiles ``transformer_explainability_torch/csrc/*.cu``
as plain C++ with g++ (threads for CUDA threads, barriers for
``__syncthreads``/``__syncwarp``/warp shuffles) and the tests call the same
host launchers the wrappers call, through ``ctypes``, on CPU tensors. Each
kernel is held to its plain PyTorch version: float64 at rtol 1e-9 /
atol 1e-12, float32 (forward only; the reverse's safe-divide chains make
float32 ill-posed) at rtol 1e-5 / atol 1e-6. The block megakernels, the
BERT layer kernels and the tensor-parallel MLP kernels (float32 only), and
the float32 attention kernels in their bf16 modes, B5 in float32 in
every mode, and the rollout B1 in float32, are held to their plain
versions in float64 by the rule of
``chip_smoke.py``: the kernel's distance to the
float64 plain result is at most 10 × the plain float32 version's plus 1e-6
of the output's magnitude. This checks the kernels' indexing, tiling,
masking of ragged edges and padded attention masks, and reductions; timing,
the memory model and the compiler of the card are only checked on the card
(``chip_smoke.py``).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from transformer_explainability_torch.ops import _build
from transformer_explainability_torch.ops import bert_math as bmath
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as P
from transformer_explainability_torch.ops import relprop as rp

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emulator")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the CUDA emulator")
    out = tmp_path_factory.mktemp("emu") / "libte_emulated.so"
    cmd = [gxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared",
           "-fPIC", "-pthread",
           "-I", EMU, "-o", str(out), os.path.join(EMU, "shared_memory.cpp"),
           "-x", "c++", *map(str, _build.sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return _build.declare(ctypes.CDLL(str(out)))


def _randn(seed, *shape, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).to(dtype)


SHAPES = [(2, 29, 3, 8), (1, 70, 2, 64)]     # (B, n, h, hd), ragged n


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_attn_fwd_kernel_matches_plain(lib, shape, dtype):
    b, n, h, d = shape
    qkv = _randn(0, b, n, 3 * h * d, dtype=dtype)
    got = K._launch_attn_fwd(lib, qkv, h, d, d ** -0.5, None)
    want = K.attn_fwd_core_plain(qkv, h, d, d ** -0.5)
    tol = (dict(rtol=1e-9, atol=1e-12) if dtype == torch.float64
           else dict(rtol=1e-5, atol=1e-6))
    torch.testing.assert_close(got, want, **tol)


# B5's row pass across its tiles: n = 2·64 + 5 spans three 64-row query
# tiles (the last ragged), two 128-key steps of the V sweep and nine 16-key
# steps of the K sweep's tensor-core product, and three 64-key column tiles;
# n = 256 + 5 takes the shared-memory softmax pass of B4's tile (above 256
# keys), smaller query tiles (shared memory) and hd 8
B5_SHAPES = SHAPES + [(1, 2 * 64 + 5, 2, 64), (1, 256 + 5, 1, 8)]


def _check_attn_rev(lib, shape, attn, rule, seeds):
    """float64 at rtol 1e-9, float32 by the rule below, from one set of
    inputs."""
    b, n, h, d = shape
    # q, k, v offset from 0 so that the z-rule denominators (q·k, attn·v)
    # stay away from 0, where float64 summation order alone moves results
    # by more than 1e-9 (the comparison would measure conditioning)
    qkv = _randn(seeds[0], b, n, 3 * h * d) + 1.0
    g_o, cam_o = _randn(seeds[1], b, n, h * d), _randn(seeds[2], b, n, h * d)
    flags = (K._ATTN_BF16[attn], K._ATTN_BF16[rule])
    got = K._launch_attn_rev(lib, qkv, g_o, cam_o, h, d, d ** -0.5, None,
                             *flags)
    want = K.attn_rev_core_plain(qkv, g_o, cam_o, h, d, d ** -0.5, attn, rule)
    args32 = tuple(t.float() for t in (qkv, g_o, cam_o))
    got32 = K._launch_attn_rev(lib, *args32, h, d, d ** -0.5, None, *flags)
    want32 = K.attn_rev_core_plain(*args32, h, d, d ** -0.5, attn, rule)
    for g, g32, w, w32, name in zip(got, got32, want, want32,
                                    ["g_qkv", "cam_qkv", "gc"]):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12, msg=name)
        _f32_rule(g32, w32, w, name)


@pytest.mark.parametrize("shape", B5_SHAPES)
def test_attn_rev_kernel_matches_plain(lib, shape):
    _check_attn_rev(lib, shape, "float32", "float32", (1, 2, 3))


def _check_rollout(lib, cams, start_layer, row_normalize, rows, grads=None):
    """float64 at rtol 1e-9, float32 by the rule below, from one set of
    inputs."""
    got = K._launch_rollout(lib, cams, start_layer, row_normalize, None,
                            grads, rows)
    want = K.rollout_plain(cams, start_layer, row_normalize, grads, rows)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    c32, g32 = cams.float(), None if grads is None else grads.float()
    _f32_rule(K._launch_rollout(lib, c32, start_layer, row_normalize, None,
                                g32, rows),
              K.rollout_plain(c32, start_layer, row_normalize, g32, rows),
              want, f"rollout rows={rows}")


# the chain's two forms (rows=None: every row block of R = 12 rows; rows=1:
# the one-row blocks); n = 12·11 + 5 makes the last row block ragged and
# splits each layer into ring tiles with a ragged last one (the row form's
# 124 + 13 in float32, 62 + 62 + 13 in float64; the full form's 3 × 49 and
# 5 × 24 + 17), so tiles wrap the ring's slots and their sources' 16-byte
# phases vary
@pytest.mark.parametrize("rows", [None, 1])
@pytest.mark.parametrize("n", [37, 12 * 11 + 5])
@pytest.mark.parametrize("start_layer", [0, 1, 3])
@pytest.mark.parametrize("row_normalize", [False, True])
def test_rollout_kernel_matches_plain(lib, start_layer, row_normalize, n,
                                      rows):
    cams = _randn(4, 2, 4, n, n).abs() * 0.05
    _check_rollout(lib, cams, start_layer, row_normalize, rows)


# the per-head input: the head-mean pass, then the chain, against
# head_mean_grad_cam followed by the plain chain
@pytest.mark.parametrize("rows", [None, 1])
@pytest.mark.parametrize("with_grads", [False, True])
@pytest.mark.parametrize("start_layer,row_normalize", [(0, False), (2, True)])
def test_rollout_kernel_per_head_matches_plain(lib, start_layer,
                                               row_normalize, with_grads,
                                               rows):
    cams = _randn(8, 2, 4, 3, 29, 29) * 0.1
    grads = _randn(9, 2, 4, 3, 29, 29) if with_grads else None
    _check_rollout(lib, cams, start_layer, row_normalize, rows, grads)


# above 1024 tokens the row form walks its columns in passes of 512 (the
# wide instance): n = 1031 takes three, the last one ragged
@pytest.mark.parametrize("row_normalize", [False, True])
def test_rollout_kernel_wide_row_form_matches_plain(lib, row_normalize):
    cams = _randn(10, 1, 2, 1031, 1031).abs() * 1e-3
    _check_rollout(lib, cams, 0, row_normalize, 1)


def test_launch_errors_reach_the_wrapper(lib):
    """A refused launch comes back as a CUDA error code and raises."""
    qkv = _randn(5, 1, 3, 3 * 128)
    g_o = _randn(6, 1, 3, 128)
    with pytest.raises(RuntimeError, match="attn_rev_core"):
        K._launch_attn_rev(lib, qkv, g_o, g_o, 1, 128, 1.0, None)
    with pytest.raises(RuntimeError, match="rollout_from_grad_cam"):
        K._launch_rollout(lib, _randn(7, 1, 2, 5, 5), 2, False, None)


# ---------------------------------------------------------------------------
# Block megakernels B2 / B3 (float32 kernels against float64 plain versions)
# ---------------------------------------------------------------------------

F32_FACTOR, F32_FLOOR = 10.0, 1e-6
EPS = 1e-6
# (mxu, attn_mxu, rule_mxu, mlp_mxu) as the presets resolve them
PRESETS = {"production": ("tensorfloat32", "float32", "bfloat16", "bfloat16"),
           "bfloat16": ("bfloat16", "bfloat16", "bfloat16", None)}
BLOCK_SHAPES = [(2, 13, 2, 16), (1, 37, 3, 8)]     # (B, n, h, hd), ragged n


def _block_case(seed, b, n, h, hd, base):
    """Random block parameters (float64 and float32, one shared set of
    prepared bf16 weights) and an input x (B, n, D) offset from 0."""
    rng = np.random.RandomState(seed)
    D, M = h * hd, 4 * h * hd

    def w(o, i):
        return torch.from_numpy(rng.randn(o, i) / np.sqrt(i))

    def vec(k, centre=0.0):
        return torch.from_numpy(centre + 0.1 * rng.randn(k))

    weights = [P.prepare_weight(t, base)
               for t in (w(3 * D, D), w(D, D), w(M, D), w(D, M))]
    vecs = [vec(D, 1.0), vec(D), vec(D, 1.0), vec(D), vec(3 * D), vec(D),
            vec(M), vec(D)]
    p64 = bm.BlockParams(*vecs, *weights)
    p32 = bm.BlockParams(*[v.float() for v in vecs], *weights)
    x = torch.from_numpy(rng.randn(b, n, D) + 0.5)
    return p64, p32, x


def _f32_rule(k32, p32, p64, name):
    assert torch.isfinite(k32).all(), name
    ek = (k32.double() - p64).abs().max().item()
    ep = (p32.double() - p64).abs().max().item()
    lim = F32_FACTOR * ep + F32_FLOOR * p64.abs().max().item()
    assert ek <= lim, f"{name}: kernel error {ek:.3e} above {lim:.3e}"


# B3's attention reverse across its tiles: n = 2·64 + 5 spans five 32-row
# query tiles of the row pass, three streamed 64-key tiles and three 64-key
# column tiles, the last of each ragged, its (n, n) rows copied in 4-byte
# pieces; n = 64 + 8 two of each (three query tiles) in 16-byte pieces, hd 8
BLOCK_TILE_SHAPES = [(1, 2 * 64 + 5, 1, 64), (2, 64 + 8, 2, 8)]


# B2's attention core is B4's tile: also across its 64-row query tiles
# (three at n = 2·64 + 5, two at 64 + 8), and at n = 256 + 5, above the keys
# whose softmax stays in registers
@pytest.mark.parametrize("shape", BLOCK_SHAPES + BLOCK_TILE_SHAPES
                         + [(1, 256 + 5, 1, 8)])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_block_fwd_kernel_matches_plain(lib, shape, preset):
    b, n, h, hd = shape
    mxu, attn, _, mlp = PRESETS[preset]
    p64, p32, x = _block_case(20, b, n, h, hd, mxu)
    flags = K._block_modes("block_fwd_core", p32, mxu=mxu, mlp=mlp or mxu,
                           attn_bf16=attn)
    got = K._launch_block_fwd(lib, x.float(), p32, h, hd, EPS, flags, None)
    want64 = bm.block_fwd_core_plain(x, p64, h, hd, EPS, mxu, attn, mlp,
                                     save_attn=True, save_mlp=True)
    want32 = bm.block_fwd_core_plain(x.float(), p32, h, hd, EPS, mxu, attn,
                                     mlp, save_attn=True, save_mlp=True)
    names = ["x_out", "x_mid", "out_m", "qkv_pre", "proj_pre", "dots",
             "probs", "fc1_pre", "fc2_pre"]
    for k, p, q, name in zip(got, want32, want64, names):
        assert k.shape == q.shape, name
        _f32_rule(k, p, q, name)


def _check_block_rev(lib, shape, preset):
    b, n, h, hd = shape
    mxu, attn, rule, mlp = PRESETS[preset]
    p64, p32, x = _block_case(21, b, n, h, hd, mxu)
    fwd = bm.block_fwd_core_plain(x, p64, h, hd, EPS, mxu, attn, mlp,
                                  save_attn=True, save_mlp=True)
    rng = np.random.RandomState(22)
    g_out, R = (torch.from_numpy(rng.randn(*x.shape)) for _ in range(2))
    args64 = (x, fwd[1], fwd[2], g_out, R)
    args32 = tuple(t.float() for t in args64)
    saved64 = fwd[3:]
    saved32 = tuple(t.float() for t in saved64)
    flags = K._block_modes("block_rev_core", p32, mxu=mxu, mlp=mlp or mxu,
                           rule=rule, attn_bf16=attn, rule_bf16=rule)
    got = K._launch_block_rev(lib, *args32, saved32, p32, h, hd, EPS, flags,
                              None)
    want64 = bm.block_rev_core_plain(*args64, p64, h, hd, EPS, mxu, attn,
                                     rule, mlp, saved=saved64)
    want32 = bm.block_rev_core_plain(*args32, p32, h, hd, EPS, mxu, attn,
                                     rule, mlp, saved=saved32)
    for k, p, q, name in zip(got, want32, want64, ["g_in", "R_in", "gc"]):
        _f32_rule(k, p, q, name)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_block_rev_kernel_matches_plain(lib, shape, preset):
    _check_block_rev(lib, shape, preset)


@pytest.mark.parametrize("shape", BLOCK_TILE_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_block_rev_kernel_tiles_match_plain(lib, shape, preset):
    _check_block_rev(lib, shape, preset)


# ---------------------------------------------------------------------------
# BERT layer kernels B7 / B8 / B9 (float32 kernels against float64 plain
# versions, masked samples)
# ---------------------------------------------------------------------------

BERT_EPS = 1e-12
# (B, S, h, hd, I); S=70 takes several row tiles
BERT_SHAPES = [(2, 13, 2, 8, 32), (1, 21, 4, 6, 48), (2, 70, 2, 8, 16)]


def _bert_case(seed, b, S, h, hd, inter, base):
    """Random layer parameters (float64 and float32, one shared set of
    prepared bf16 weights), an input x (B, S, D) and additive masks whose
    padded tails differ per sample."""
    rng = np.random.RandomState(seed)
    D = h * hd

    def w(o, i):
        return torch.from_numpy(rng.randn(o, i) / np.sqrt(i))

    def vec(k, centre=0.0):
        return torch.from_numpy(centre + 0.1 * rng.randn(k))

    weights = [P.prepare_weight(t, base)
               for t in (w(3 * D, D), w(D, D), w(inter, D), w(D, inter))]
    vecs = [vec(D, 1.0), vec(D), vec(D, 1.0), vec(D), vec(3 * D), vec(D),
            vec(inter), vec(D)]
    p64 = bmath.BertLayerParams(*vecs, *weights)
    p32 = bmath.BertLayerParams(*[v.float() for v in vecs], *weights)
    x = torch.from_numpy(rng.randn(b, S, D))
    keep = np.arange(S)[None, :] < (S - 4 * np.arange(b))[:, None]
    mask = torch.from_numpy((1.0 - keep) * -10000.0)
    return p64, p32, x, mask


def _masks(S, lengths):
    """Additive (B, S) masks cutting each sample at its own length."""
    keep = np.arange(S)[None, :] < np.asarray(lengths)[:, None]
    return torch.from_numpy((1.0 - keep) * -10000.0)


def _check_bert_fwd(lib, shape, preset, lengths=None):
    b, S, h, hd, inter = shape
    mxu, attn, _, mlp = PRESETS[preset]
    p64, p32, x, mask = _bert_case(30, b, S, h, hd, inter, mxu)
    if lengths is not None:
        mask = _masks(S, lengths)
    flags = K._block_modes("bert_layer_fwd_core", p32, mxu=mxu,
                           mlp=mlp or mxu, attn_bf16=attn)
    got = K._launch_bert_fwd(lib, x.float(), mask.float(), p32, h, hd,
                             BERT_EPS, flags, None)
    args = (h, hd, BERT_EPS, mxu, attn, mlp)
    want64 = bmath.bert_layer_fwd_core_plain(x, mask, p64, *args,
                                             save_attn=True)
    want32 = bmath.bert_layer_fwd_core_plain(x.float(), mask.float(), p32,
                                             *args, save_attn=True)
    for k, p, q, name in zip(got, want32, want64, ["out", "att_ln", "qkv_pre",
                                                   "ctx", "dense_nb"]):
        assert k.shape == q.shape, name
        _f32_rule(k, p, q, name)


@pytest.mark.parametrize("shape", BERT_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bert_fwd_kernel_matches_plain(lib, shape, preset):
    _check_bert_fwd(lib, shape, preset)


@pytest.mark.parametrize("shape", BERT_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bert_out_rev_kernel_matches_plain(lib, shape, preset):
    b, S, h, hd, inter = shape
    mxu, attn, rule, mlp = PRESETS[preset]
    p64, p32, x, mask = _bert_case(31, b, S, h, hd, inter, mxu)
    att_ln = bmath.bert_layer_fwd_core_plain(x, mask, p64, h, hd, BERT_EPS,
                                             mxu, attn, mlp)[1]
    rng = np.random.RandomState(32)
    g_out, R = (torch.from_numpy(rng.randn(*x.shape)) for _ in range(2))
    a64 = (att_ln, g_out, R)
    a32 = tuple(t.float() for t in a64)
    flags = K._block_modes("bert_out_rev_core", p32, mlp=mlp or mxu,
                           rule=rule)
    got = K._launch_bert_out_rev(lib, *a32, p32, BERT_EPS, flags, None)
    want64 = bmath.bert_out_rev_core_plain(*a64, p64, BERT_EPS, mxu, rule,
                                           mlp)
    want32 = bmath.bert_out_rev_core_plain(*a32, p32, BERT_EPS, mxu, rule,
                                           mlp)
    for k, p, q, name in zip(got, want32, want64, ["g_attln", "R_att"]):
        _f32_rule(k, p, q, name)


def _check_bert_attn_rev(lib, shape, preset, lengths=None):
    b, S, h, hd, inter = shape
    mxu, attn, rule, mlp = PRESETS[preset]
    p64, p32, x, mask = _bert_case(33, b, S, h, hd, inter, mxu)
    if lengths is not None:
        mask = _masks(S, lengths)
    fwd = bmath.bert_layer_fwd_core_plain(x, mask, p64, h, hd, BERT_EPS, mxu,
                                          attn, mlp, save_attn=True)
    rng = np.random.RandomState(34)
    g_attln, R_att = (torch.from_numpy(rng.randn(*x.shape)) for _ in range(2))
    a64, s64 = (x, g_attln, R_att, mask), fwd[2:]
    a32, s32 = tuple(t.float() for t in a64), tuple(t.float() for t in s64)
    flags = K._block_modes("bert_attn_rev_core", p32, mxu=mxu, rule=rule,
                           attn_bf16=attn, rule_bf16=rule)
    got = K._launch_bert_attn_rev(lib, *a32, s32, p32, h, hd, BERT_EPS,
                                  flags, None)
    args = (h, hd, BERT_EPS, mxu, attn, rule)
    want64 = bmath.bert_attn_rev_core_plain(*a64, p64, *args, saved=s64)
    want32 = bmath.bert_attn_rev_core_plain(*a32, p32, *args, saved=s32)
    for k, p, q, name in zip(got, want32, want64, ["g_in", "R_in", "gc"]):
        _f32_rule(k, p, q, name)


@pytest.mark.parametrize("shape", BERT_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bert_attn_rev_kernel_matches_plain(lib, shape, preset):
    _check_bert_attn_rev(lib, shape, preset)


# S=150 spans five 32-row query tiles and three streamed 64-key tiles of
# B9's row pass, the last of each ragged; the masks cut the samples inside
# the last key tile and inside the second
BERT_TILE_SHAPES = [(2, 150, 1, 64, 32), (2, 150, 2, 8, 24)]


@pytest.mark.parametrize("shape", BERT_TILE_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bert_attn_rev_kernel_tiles_match_plain(lib, shape, preset):
    _check_bert_attn_rev(lib, shape, preset, lengths=(150, 97))


# S=96 (rows of the (S, S) maps 16-byte aligned, so the column pass copies
# them in 16-byte pieces; at S=150 in 4-byte ones) spans two of the column
# pass's 64-key tiles, the last half full, and three 32-row stages
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bert_attn_rev_kernel_column_tiles_match_plain(lib, preset):
    _check_bert_attn_rev(lib, (2, 96, 1, 64, 32), preset, lengths=(96, 71))


# B7's attention core at S=150: three 64-row query tiles and three streamed
# 64-key tiles, the last of each ragged; the masks cut the samples inside the
# last key tile and inside the second
@pytest.mark.parametrize("shape", BERT_TILE_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bert_fwd_kernel_tiles_match_plain(lib, shape, preset):
    _check_bert_fwd(lib, shape, preset, lengths=(150, 97))


# ---------------------------------------------------------------------------
# B4 / B5 in the product modes of the tensor-parallel presets
# ---------------------------------------------------------------------------

# (attn_mxu, rule_mxu) of the presets where they differ from exact FP32
ATTN_MODES = {"production": ("float32", "bfloat16"),
              "bfloat16": ("bfloat16", "bfloat16")}


@pytest.mark.parametrize("shape", SHAPES)
def test_attn_fwd_kernel_bf16_matches_plain(lib, shape):
    """float64 at rtol 1e-9 (both round the same operands to bf16), and
    float32 by the rule above."""
    b, n, h, d = shape
    qkv = _randn(40, b, n, 3 * h * d)
    flag = K._ATTN_BF16["bfloat16"]
    got = K._launch_attn_fwd(lib, qkv, h, d, d ** -0.5, None, flag)
    want = K.attn_fwd_core_plain(qkv, h, d, d ** -0.5, "bfloat16")
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    got32 = K._launch_attn_fwd(lib, qkv.float(), h, d, d ** -0.5, None, flag)
    _f32_rule(got32, K.attn_fwd_core_plain(qkv.float(), h, d, d ** -0.5,
                                           "bfloat16"), want, "out")


# n = 2·64 + 5 spans three of B4's 64-row query tiles, the last ragged, in
# one 256-key score tile (the softmax in registers); n = 256 + 5 spans two
# key tiles (the softmax pass over shared memory); hd 8 leaves most of the
# 64 padded columns zero
B4_TILE_SHAPES = [(1, 2 * 64 + 5, 2, 64), (2, 2 * 64 + 5, 3, 8),
                  (1, 256 + 5, 1, 8)]


@pytest.mark.parametrize("shape", B4_TILE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", sorted(K._ATTN_BF16))
def test_attn_fwd_kernel_tiles_match_plain(lib, shape, dtype, mode):
    """float64 at rtol 1e-9; float32 by the rule above, in bf16 mode
    against the plain float32 version within one re-rounding: an ulp
    between two float32 probabilities can round them to bf16 values 2⁻⁸
    apart, which moves an output by up to 2⁻⁸·max|v|, and at this size
    whether the kernel or the plain version meets such a tie is a draw."""
    b, n, h, d = shape
    qkv = _randn(44, b, n, 3 * h * d)
    flag = K._ATTN_BF16[mode]
    got = K._launch_attn_fwd(lib, qkv.to(dtype), h, d, d ** -0.5, None, flag)
    want = K.attn_fwd_core_plain(qkv, h, d, d ** -0.5, mode)
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    else:
        plain32 = K.attn_fwd_core_plain(qkv.float(), h, d, d ** -0.5, mode)
        if mode == "float32":
            _f32_rule(got, plain32, want, "out")
        else:
            v_max = qkv[..., 2 * h * d:].abs().max().item()
            torch.testing.assert_close(got, plain32, rtol=0,
                                       atol=2 ** -8 * v_max)


# B5's mode pairs beyond exact FP32: the presets' and the pair no preset
# runs (bf16 gradient products, float32 rules), which rounds the operands
# its products share as they are loaded
B5_MODES = {**ATTN_MODES, "bf16-attn-f32-rule": ("bfloat16", "float32")}


@pytest.mark.parametrize("shape", B5_SHAPES)
@pytest.mark.parametrize("preset", sorted(B5_MODES))
def test_attn_rev_kernel_modes_match_plain(lib, shape, preset):
    _check_attn_rev(lib, shape, *B5_MODES[preset], (41, 42, 43))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_attn_rev_probs_are_b2_anchors(lib, preset):
    """B5 recomputes the probabilities by B4's tile, the function whose
    anchor instance saves B2's: from B2's own qkv (qkv_pre + bqkv, as its
    epilogue adds them) B5's P is bitwise B2's probs, at a shape that takes
    the in-register softmax and at one above 256 keys."""
    mxu, attn, rule, mlp = PRESETS[preset]
    for b, n, h, hd in [(1, 2 * 64 + 5, 2, 64), (1, 256 + 5, 1, 8)]:
        _, p32, x = _block_case(23, b, n, h, hd, mxu)
        flags = K._block_modes("block_fwd_core", p32, mxu=mxu,
                               mlp=mlp or mxu, attn_bf16=attn)
        fwd = K._launch_block_fwd(lib, x.float(), p32, h, hd, EPS, flags,
                                  None)
        qkv = fwd[3] + p32.bqkv
        probs = fwd[6].reshape(b, h, n, n)
        g_o, cam_o = (torch.from_numpy(np.random.RandomState(24 + i).randn(
            b, n, h * hd)).float() for i in range(2))
        outs = [torch.empty_like(qkv), torch.empty_like(qkv),
                torch.empty(b, n, n)]
        maps = [torch.empty(b, h, n, n) for _ in range(4)]   # P, G, S2, GCP
        S1 = torch.empty(b, h, n, hd)
        code = lib.te_attn_rev_f32(
            *[t.data_ptr() for t in (qkv, g_o, cam_o, *outs, *maps, S1)],
            b, n, h, hd, hd ** -0.5, K._ATTN_BF16[attn], K._ATTN_BF16[rule],
            None)
        assert code == 0
        assert torch.equal(maps[0].view(torch.int32),
                           probs.view(torch.int32)), (b, n, h, hd)


# ---------------------------------------------------------------------------
# Tensor-parallel MLP reverse B10a / B10b (float32 kernels against float64
# plain versions), at one shard's widths
# ---------------------------------------------------------------------------

# (B, n, D, M/k); the third: a ragged last row tile (133 = 128 + 5 rows),
# D and M/k multiples of 8 but of no tile width, and K deeper than the
# rings of the fused passes (D = 136 > 2 stages of 64, M/k = 264 > 4)
TP_SHAPES = [(2, 13, 16, 24), (1, 37, 24, 40), (1, 133, 136, 264)]


@pytest.mark.parametrize("shape", TP_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_mlp_rev_tp_kernels_match_plain(lib, shape, preset):
    b, n, D, Ml = shape
    base, _, rule, mlp = PRESETS[preset]
    mlp = mlp or base
    rng = np.random.RandomState(50)
    w1, w2 = (P.prepare_weight(torch.from_numpy(rng.randn(o, i) / np.sqrt(i)),
                               base) for o, i in ((Ml, D), (D, Ml)))
    vecs64 = [torch.from_numpy(c + 0.1 * rng.randn(k))
              for c, k in ((1.0, D), (0.0, D), (0.0, Ml))]
    x64 = torch.from_numpy(rng.randn(b, n, D) + 0.5)
    g64 = torch.from_numpy(rng.randn(b, n, D))
    vecs32 = [v.float() for v in vecs64]
    flags = K._tp_modes("mlp_rev_tp_phase1", x64.float(), (w1, w2), mlp=mlp,
                        rule=rule)
    got = K._launch_mlp_rev_tp1(lib, x64.float(), g64.float(), *vecs32, w1,
                                w2, EPS, flags, None)
    want64 = K.mlp_rev_tp_phase1_plain(x64, g64, *vecs64, w1, w2, EPS, mlp,
                                       rule)
    want32 = K.mlp_rev_tp_phase1_plain(x64.float(), g64.float(), *vecs32, w1,
                                       w2, EPS, mlp, rule)
    for k, p, q, name in zip(got, want32, want64,
                             ["fc1_pre", "fc2_pre", "axw2", "g_xn2"]):
        assert k.shape == q.shape, name
        _f32_rule(k, p, q, name)
    # phase 2 from the float64 phase 1's anchor and a divide Sr formed as
    # the TP program forms it
    R2 = torch.from_numpy(rng.randn(b, n, D))
    Sr = rp.safe_divide(R2, 0.5 * (want64[1] + want64[2]))
    a64 = (x64, Sr, want64[0])
    a32 = tuple(t.float() for t in a64)
    got = K._launch_mlp_rev_tp2(lib, *a32, *vecs32, w1, w2, EPS,
                                {"rule": flags["rule"]}, None)
    want64 = K.mlp_rev_tp_phase2_plain(*a64, *vecs64, w1, w2, EPS, rule)
    want32 = K.mlp_rev_tp_phase2_plain(*a32, *vecs32, w1, w2, EPS, rule)
    for k, p, q, name in zip(got, want32, want64, ["num_w", "num_a"]):
        _f32_rule(k, p, q, name)


@pytest.mark.parametrize("grid", [0, 1])
@pytest.mark.parametrize("shape", TP_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_mlp_rev_tp_fused_passes_are_bitwise_separate(lib, shape, preset,
                                                       grid):
    """In the presets' modes each phase runs the core's fused passes (phase
    1: the two-operand pass and one grouped launch; phase 2: the three-set
    pass and the dual, with hg, g_h1 and S1 stored as bf16): every output
    is bitwise what the separate launches give (fused = 0), also when one
    persistent block walks every tile (grid = 1)."""
    b, n, D, Ml = shape
    base, _, rule, mlp = PRESETS[preset]
    mlp = mlp or base
    rng = np.random.RandomState(51)
    w1, w2 = (P.prepare_weight(torch.from_numpy(rng.randn(o, i) / np.sqrt(i)),
                               base) for o, i in ((Ml, D), (D, Ml)))
    vecs = [torch.from_numpy(c + 0.1 * rng.randn(k)).float()
            for c, k in ((1.0, D), (0.0, D), (0.0, Ml))]
    x, g = (torch.from_numpy(rng.randn(b, n, D) + c).float()
            for c in (0.5, 0.0))
    flags = K._tp_modes("mlp_rev_tp_phase1", x, (w1, w2), mlp=mlp, rule=rule)
    prev = lib.te_gemm_grid_cap(grid)
    try:
        p1 = [K._launch_mlp_rev_tp1(lib, x, g, *vecs, w1, w2, EPS, flags, None,
                                    fused=f) for f in (True, False)]
        Sr = torch.from_numpy(rng.randn(b, n, D)).float()
        p2 = [K._launch_mlp_rev_tp2(lib, x, Sr, p1[0][0], *vecs, w1, w2, EPS,
                                    {"rule": flags["rule"]}, None, fused=f)
              for f in (True, False)]
    finally:
        lib.te_gemm_grid_cap(prev)
    names = ["fc1_pre", "fc2_pre", "axw2", "g_xn2", "num_w", "num_a"]
    for f, s_, name in zip((*p1[0], *p2[0]), (*p1[1], *p2[1]), names):
        assert torch.isfinite(f).all(), name
        assert torch.equal(f.view(torch.int32), s_.view(torch.int32)), name


# ---------------------------------------------------------------------------
# The split path's MLP reverse B6 (float32 kernel against float64 plain
# versions), in its two product-mode pairs
# ---------------------------------------------------------------------------

MLP_SHAPES = [(2, 13, 16, 40), (1, 37, 24, 96)]     # (B, n, D, M)
# (weight preparation and MLP mode, rule mode)
MLP_MODES = [("bfloat16", "bfloat16"), ("tensorfloat32", "bfloat16")]


@pytest.mark.parametrize("shape", MLP_SHAPES)
@pytest.mark.parametrize("modes", MLP_MODES)
def test_mlp_rev_kernel_matches_plain(lib, shape, modes):
    b, n, D, M = shape
    mlp, rule = modes
    rng = np.random.RandomState(60)
    w1, w2 = (P.prepare_weight(torch.from_numpy(rng.randn(o, i) / np.sqrt(i)),
                               mlp) for o, i in ((M, D), (D, M)))
    vecs64 = [torch.from_numpy(c + 0.1 * rng.randn(k))
              for c, k in ((1.0, D), (0.0, D), (0.0, M), (0.0, D))]
    z = torch.zeros(1, dtype=torch.float64)

    def params(vecs):
        ln2s, ln2b, b1, b2 = vecs
        return bm.BlockParams(z, z, ln2s, ln2b, z, z, b1, b2, None, None,
                              w1, w2)

    p64, p32 = params(vecs64), params([v.float() for v in vecs64])
    a64 = tuple(torch.from_numpy(rng.randn(b, n, D) + c)
                for c in (0.5, 0.0, 0.0))          # x_mid, g_out, R
    a32 = tuple(t.float() for t in a64)
    flags = K._tp_modes("mlp_rev_core", a32[0], (w1, w2), mlp=mlp, rule=rule)
    got = K._launch_mlp_rev(lib, *a32, p32, EPS, flags, None)
    want64 = K.mlp_rev_core_plain(*a64, p64, EPS, mlp, rule)
    want32 = K.mlp_rev_core_plain(*a32, p32, EPS, mlp, rule)
    for k, p, q, name in zip(got, want32, want64, ["g_mid", "Rm"]):
        assert k.shape == q.shape, name
        _f32_rule(k, p, q, name)


# ---------------------------------------------------------------------------
# The GEMM core alone (csrc/gemm.cu: the core with a store epilogue): each
# instance the layer kernels launch, in both modes and both tiles, held to
# precision.kdot on the same split operands in float64
# ---------------------------------------------------------------------------

# (wt, absolute, dual): the forward products x·Wᵀ, the backward products
# g·W, the rule denominators |x|·|W|ᵀ, the rule numerators S·W and S·|W|;
# then the tensor-parallel MLP kernels' instances, bf16 products only: g·W
# and S·W / S·|W| on bf16 A rows ("bf16 A"), and the fused passes (kernels.
# FUSED_KINDS: two A operands, the dual whose second product takes |A|,
# three sets, and the grouped launch)
CORE_INSTANCES = [(True, False, False), (False, False, False),
                  (True, True, False), (False, False, True),
                  "bf16 A", "bf16 A dual", "two_a", "dual_abs_a", "three",
                  "group"]
# (tile, M, N, K, grid): the large tile (128 rows × 192 / 128 / 64 columns
# for 1 / 2 / 4 accumulator sets) and the small one (64 × 128 / 128 / 64),
# each at a shape with a ragged last row tile, N a multiple of 8 but of no
# tile width, and K not a multiple of the 64-deep stage; K = 264 takes five
# stages through a ring of two to four. grid 1: one persistent block walks
# every tile (four or more; a grouped launch's, of both products). The
# fused passes take the large tile.
CORE_SHAPES = [(0, 136, 200, 264, 0), (1, 70, 136, 72, 0),
               (0, 136, 200, 264, 1), (1, 70, 136, 72, 1)]


def _fused_case(rng, kind, M, N, Kd):
    """Operands of one fused pass: a0, w0, a1, w1 (bf16 rows; weights (N, K)
    where transposed, else (K, N)), and whether each output's weight is
    transposed."""
    def weight(shape):
        return P.prepare_weight(torch.from_numpy(rng.randn(*shape)
                                                 / np.sqrt(Kd)), "bfloat16")

    def rows(bf16):
        a = torch.from_numpy(rng.randn(M, Kd)).float()
        return a.to(torch.bfloat16) if bf16 else a

    tk, kn = (N, Kd), (Kd, N)
    return {"two_a": (rows(True), weight(tk), rows(True), weight(kn),
                      (True, False)),
            "dual_abs_a": (rows(True), weight(tk), None, None, (True, True)),
            "three": (rows(True), weight(kn), rows(True), weight(tk),
                      (False, False, True)),
            "group": (rows(True), weight(tk), rows(True), weight(kn),
                      (True, True, False))}[kind]


def _core_mag(a, w, wt):
    """|a|·|w| (float64), the scale of one output's accumulation error."""
    wv = sum(t.double() for t in w).abs()
    return a.double().abs() @ (wv.t() if wt else wv)


@pytest.mark.parametrize("shape", CORE_SHAPES)
@pytest.mark.parametrize("mode", sorted(K._GEMM_MODE))
@pytest.mark.parametrize("instance", CORE_INSTANCES)
def test_gemm_core_tiles_match_kdot(lib, shape, mode, instance):
    tile, M, N, Kd, grid = shape
    rng = np.random.RandomState(70 + tile)
    prev = lib.te_gemm_grid_cap(grid)
    try:
        if isinstance(instance, str):
            _check_core_bf16_instance(lib, rng, instance, mode, tile, M, N,
                                      Kd)
            return
        wt, absolute, dual = instance
        a = torch.from_numpy(rng.randn(M, Kd)).float()
        w = P.prepare_weight(torch.from_numpy(
            rng.randn(*((N, Kd) if wt else (Kd, N))) / np.sqrt(Kd)), mode)
        got = K._launch_gemm(lib, a, w, K._GEMM_MODE[mode], wt, absolute,
                             dual, tile, None)
    finally:
        lib.te_gemm_grid_cap(prev)
    want = K.gemm_core_plain(a.double(), w, mode, wt, absolute, dual)
    mag = _core_mag(a, w, wt)
    got, want = (got, want) if dual else ((got,), (want,))
    for g, q in zip(got, want):
        assert g.shape == (M, N) and g.dtype == torch.float32
        # float32 sums over K in the emulator: each output within
        # K·2⁻²⁴ of Σ|a·w| of the float64 sum of the same bf16 products
        err = ((g.double() - q).abs() / mag).max().item()
        assert err <= Kd * 2.0 ** -24, err


def _check_core_bf16_instance(lib, rng, instance, mode, tile, M, N, Kd):
    """The tensor-parallel MLP kernels' instances: one-pass bf16 products,
    held to kdot in float64 as above; in bf16×3 the core refuses them."""
    flag = K._GEMM_MODE[mode]
    if instance.startswith("bf16 A"):
        dual = instance.endswith("dual")
        a = torch.from_numpy(rng.randn(M, Kd)).to(torch.bfloat16)
        w = P.prepare_weight(torch.from_numpy(rng.randn(Kd, N)
                                              / np.sqrt(Kd)), mode)
        run = lambda: K._launch_gemm(lib, a, w, flag, False, False, dual,
                                     tile, None)
        if mode != "bfloat16":
            with pytest.raises(RuntimeError, match="gemm_core"):
                run()
            return
        got = run()
        got = got if dual else (got,)
        want = K.gemm_core_plain(a.double(), w, mode, False, False, dual)
        want = want if dual else (want,)
        mags = [_core_mag(a, w, False)] * len(got)
    else:
        a0, w0, a1, w1, wts = _fused_case(rng, instance, M, N, Kd)
        run = lambda: K._launch_gemm_fused(lib, instance, flag, a0, w0, a1,
                                           w1, None)
        if mode != "bfloat16":
            with pytest.raises(RuntimeError, match="gemm_core"):
                run()
            return
        got = run()
        want = K.gemm_core_fused_plain(
            instance, a0.double(), w0, None if a1 is None else a1.double(),
            w1)
        ops = {"two_a": [(a0, w0), (a1, w1)],
               "dual_abs_a": [(a0, w0), (a0, w0)],
               "three": [(a0, w0), (a0, w0), (a1, w1)],
               "group": [(a0, w0), (a0, w0), (a1, w1)]}[instance]
        mags = [_core_mag(a, w, wt) for (a, w), wt in zip(ops, wts)]
    assert len(got) == len(want)
    for g, q, mag in zip(got, want, mags):
        assert g.shape == (M, N) and g.dtype == torch.float32
        err = ((g.double() - q).abs() / mag).max().item()
        assert err <= Kd * 2.0 ** -24, err


@pytest.mark.parametrize("grid", [0, 1])
@pytest.mark.parametrize("kind", sorted(K.FUSED_KINDS) + ["bf16 A"])
def test_gemm_core_fused_passes_are_bitwise_separate(lib, kind, grid):
    """Each fused pass (and a product on bf16 A rows) gives bitwise what the
    core's separate launches give on the same operands (float32 rows that
    hold the bf16 values): each output's chain over k is the same."""
    M, N, Kd = 136, 200, 264
    rng = np.random.RandomState(71)
    prev = lib.te_gemm_grid_cap(grid)
    try:
        if kind == "bf16 A":
            a = torch.from_numpy(rng.randn(M, Kd)).to(torch.bfloat16)
            w = P.prepare_weight(torch.from_numpy(rng.randn(Kd, N)
                                                  / np.sqrt(Kd)), "bfloat16")
            got = K._launch_gemm(lib, a, w, 0, False, False, True, -1, None)
            want = K._launch_gemm(lib, a.float(), w, 0, False, False, True,
                                  -1, None)
        else:
            a0, w0, a1, w1, _ = _fused_case(rng, kind, M, N, Kd)
            got = K._launch_gemm_fused(lib, kind, 0, a0, w0, a1, w1, None)
            f0 = a0.float()
            f1 = None if a1 is None else a1.float()
            sep = lambda a, w, wt, ab=False, du=False: K._launch_gemm(
                lib, a, w, 0, wt, ab, du, -1, None)
            want = {"two_a": lambda: (sep(f0, w0, True), sep(f1, w1, False)),
                    "dual_abs_a": lambda: (sep(f0, w0, True),
                                           sep(f0, w0, True, True)),
                    "three": lambda: (*sep(f0, w0, False, du=True),
                                      sep(f1, w1, True, True)),
                    "group": lambda: (sep(f0, w0, True),
                                      sep(f0, w0, True, True),
                                      sep(f1, w1, False))}[kind]()
    finally:
        lib.te_gemm_grid_cap(prev)
    assert len(got) == len(want)
    for i, (g, q) in enumerate(zip(got, want)):
        assert torch.equal(g.view(torch.int32), q.view(torch.int32)), i


def test_gemm_core_rejects_what_it_does_not_take(lib):
    """K and N multiples of 8, and a bf16x3 product needs its lo planes."""
    a = torch.randn(16, 12)
    w = P.prepare_weight(torch.randn(16, 12, dtype=torch.float64),
                         "tensorfloat32")
    with pytest.raises(RuntimeError, match="gemm_core"):
        K._launch_gemm(lib, a, w, 1, True, False, False, -1, None)
    w1 = P.prepare_weight(torch.randn(16, 16, dtype=torch.float64),
                          "bfloat16")
    with pytest.raises(RuntimeError, match="gemm_core"):
        K._launch_gemm(lib, torch.randn(8, 16), w1, 1, True, False, False,
                       -1, None)
