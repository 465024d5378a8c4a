"""What the emulated kernel tests share: the ``lib`` fixture that builds
``transformer_explainability_torch/csrc/*.cu`` against the thread-level
emulator in ``tests/cuda_emulator``, the seeded inputs, the shapes and the
checks of each kernel against its plain PyTorch version.

The tests are split by family so that no one file sets the wall time of a
parallel run: ``test_torch_kernels_emulated_attention.py`` (B1, B4, B5),
``..._blocks.py`` (B2, B3), ``..._bert.py`` (B7, B8, B9) and
``..._mlp.py`` (B6, B10a, B10b and the GEMM core they share).
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from transformer_explainability_torch.ops import _build
from transformer_explainability_torch.ops import bert_math as bmath
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as P

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emulator")


EMU_BUILD = os.path.join(os.path.dirname(os.path.dirname(EMU)), "build",
                         "emulated")


def emulated_library(gxx: str) -> str:
    """The library of ``csrc/*.cu`` built by g++ against the emulator, once
    for every process and file that asks: cached under
    ``build/emulated/<hash>``, the hash over the command and every source,
    header and emulator file, built under a file lock and renamed into
    place."""
    flags = ["-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC",
             "-pthread", "-I", EMU]
    files = (sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob(
        "*.cuh")) + sorted(Path(EMU).iterdir()))
    h = hashlib.sha256(" ".join([gxx, *flags]).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    d = os.path.join(EMU_BUILD, h.hexdigest()[:16])
    out = os.path.join(d, "libte_emulated.so")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = os.path.join(d, f"libte_emulated.{os.getpid()}.so")
            cmd = [gxx, *flags, "-o", tmp, os.path.join(EMU,
                                                         "shared_memory.cpp"),
                   "-x", "c++", *map(str, _build.sources())]
            res = subprocess.run(cmd, capture_output=True, text=True)
            assert res.returncode == 0, res.stderr
            os.replace(tmp, out)
    return out


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The emulated library, a module's own copy of the cached build (a
    module loads it afresh, as if it had built it)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the CUDA emulator")
    out = tmp_path_factory.mktemp("emu") / "libte_emulated.so"
    shutil.copyfile(emulated_library(gxx), out)
    return _build.declare(ctypes.CDLL(str(out)))


def _randn(seed, *shape, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).to(dtype)


SHAPES = [(2, 29, 3, 8), (1, 70, 2, 64)]     # (B, n, h, hd), ragged n


# B5's row pass across its tiles: n = 2·64 + 5 spans three 64-row query
# tiles (the last ragged), two 128-key steps of the V sweep and nine 16-key
# steps of the K sweep's tensor-core product, and three 64-key column tiles;
# n = 256 + 5 takes the shared-memory softmax pass of B4's tile (above 256
# keys), smaller query tiles (shared memory) and hd 8
B5_SHAPES = SHAPES + [(1, 2 * 64 + 5, 2, 64), (1, 256 + 5, 1, 8)]


def _check_attn_rev(lib, shape, attn, rule, seeds, drawn=False):
    """float64 at rtol 1e-9, float32 by the rule below (``drawn``: by
    :func:`_f32_drawn`), from one set of inputs."""
    b, n, h, d = shape
    # q, k, v offset from 0 so that the z-rule denominators (q·k, attn·v)
    # stay away from 0, where float64 summation order alone moves results
    # by more than 1e-9 (the comparison would measure conditioning)
    qkv = _randn(seeds[0], b, n, 3 * h * d) + 1.0
    g_o, cam_o = _randn(seeds[1], b, n, h * d), _randn(seeds[2], b, n, h * d)
    flags = (K._ATTN_MODE[attn], K._ATTN_MODE[rule])
    got = K._launch_attn_rev(lib, qkv, g_o, cam_o, h, d, d ** -0.5, None,
                             *flags)
    want = K.attn_rev_core_plain(qkv, g_o, cam_o, h, d, d ** -0.5, attn, rule)
    args32 = tuple(t.float() for t in (qkv, g_o, cam_o))
    got32 = K._launch_attn_rev(lib, *args32, h, d, d ** -0.5, None, *flags)
    want32 = K.attn_rev_core_plain(*args32, h, d, d ** -0.5, attn, rule)
    names = ["g_qkv", "cam_qkv", "gc"]
    for g, g32, w, w32, name in zip(got, got32, want, want32, names):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12, msg=name)
        if not drawn:
            _f32_rule(g32, w32, w, name)
    if drawn:
        _f32_drawn(got32, lambda *a: K.attn_rev_core_plain(
            *a, h, d, d ** -0.5, attn, rule), args32, want, names)


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


# ---------------------------------------------------------------------------
# Block megakernels B2 / B3 (float32 kernels against float64 plain versions)
# ---------------------------------------------------------------------------

F32_FACTOR, F32_FLOOR = 10.0, 1e-6
EPS = 1e-6
# (mxu, attn_mxu, rule_mxu, mlp_mxu) as the presets resolve them
PRESETS = {"production": ("tensorfloat32", "float32", "bfloat16", "bfloat16"),
           "bfloat16": ("bfloat16", "bfloat16", "bfloat16", None)}
# the block kernels' bf16×3 attention and rule modes: raw tensorfloat32,
# the bfloat16 base with a tensorfloat32 attention island, and the
# tensorfloat32 base's islands that pair a bf16×3 product with another mode
TF32_PRESETS = {
    "tensorfloat32": ("tensorfloat32", "tensorfloat32", "tensorfloat32",
                      None),
    "bf16-tf32-attn": ("bfloat16", "tensorfloat32", "bfloat16", None),
    "tf32-f32-attn": ("tensorfloat32", "float32", "tensorfloat32", None),
    "tf32-bf16-attn": ("tensorfloat32", "bfloat16", "tensorfloat32", None),
    "tf32-bf16-rules": ("tensorfloat32", "tensorfloat32", "bfloat16", None),
}
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


# The float32 rule against the plain float32 version's draws: where a
# float32 output is a draw of bf16 re-roundings (an operand one float32 ulp
# from a bf16 tie rounds either way, C4) or of an ill-conditioned divide,
# the plain version on the inputs as they are may be a lucky draw. The
# limit is then taken over it and over DRAWS runs of it on the inputs with
# every element moved one float32 ulp at random (seeded): the kernel is
# held as one more float32 draw of the same function.
DRAWS = 4


def _ulp_moved(t, gen):
    s = torch.randint(-1, 2, t.shape, generator=gen)
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    down = torch.nextafter(t, torch.full_like(t, float("-inf")))
    return torch.where(s > 0, up, torch.where(s < 0, down, t))


def _f32_drawn(k32, plain, args32, p64, names, seed=7):
    """``k32``, ``p64``: the kernel's float32 and the plain float64 outputs;
    ``plain(*args)`` the plain version on float32 ``args32`` (tensors,
    each moved in the draws)."""
    gen = torch.Generator().manual_seed(seed)
    draws = [plain(*args32)] + [
        plain(*(_ulp_moved(t, gen) for t in args32)) for _ in range(DRAWS)]
    for i, name in enumerate(names):
        assert torch.isfinite(k32[i]).all(), name
        ek = (k32[i].double() - p64[i]).abs().max().item()
        ep = max((d[i].double() - p64[i]).abs().max().item() for d in draws)
        lim = F32_FACTOR * ep + F32_FLOOR * p64[i].abs().max().item()
        assert ek <= lim, (f"{name}: kernel error {ek:.3e} above {lim:.3e} "
                           f"(plain float32 draws' largest {ep:.3e})")


# B3's attention reverse across its tiles: n = 2·64 + 5 spans five 32-row
# query tiles of the row pass, three streamed 64-key tiles and three 64-key
# column tiles, the last of each ragged, its (n, n) rows copied in 4-byte
# pieces; n = 64 + 8 two of each (three query tiles) in 16-byte pieces, hd 8
BLOCK_TILE_SHAPES = [(1, 2 * 64 + 5, 1, 64), (2, 64 + 8, 2, 8)]


def _check_block_rev(lib, shape, preset):
    b, n, h, hd = shape
    mxu, attn, rule, mlp = {**PRESETS, **TF32_PRESETS}[preset]
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
                           rule=rule, attn_mode=attn, rule_mode=rule)
    got = K._launch_block_rev(lib, *args32, saved32, p32, h, hd, EPS, flags,
                              None)
    want64 = bm.block_rev_core_plain(*args64, p64, h, hd, EPS, mxu, attn,
                                     rule, mlp, saved=saved64)
    names = ["g_in", "R_in", "gc"]
    if preset in TF32_PRESETS:
        _f32_drawn(got, lambda *a: bm.block_rev_core_plain(
            *a[:5], p32, h, hd, EPS, mxu, attn, rule, mlp, saved=a[5:]),
            args32 + saved32, want64, names)
        return
    want32 = bm.block_rev_core_plain(*args32, p32, h, hd, EPS, mxu, attn,
                                     rule, mlp, saved=saved32)
    for k, p, q, name in zip(got, want32, want64, names):
        _f32_rule(k, p, q, name)


# DeiT-distilled's n = 198 (CLS, DIST and 196 patches): one token past
# ViT-B's 197, still inside the 224 keys of B4's tile's 7-group instance;
# B4 in exact FP32 and B2 (B4's tile with the anchors, the GEMM core) in
# the production preset's modes, one head of 64 columns. B5 and B3 take
# 8 and 15 s here and are held at n = 198 on the card (chip_smoke.py)
DISTILLED_SHAPE = (1, 198, 1, 64)


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
                           mlp=mlp or mxu, attn_mode=attn)
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
                           attn_mode=attn, rule_mode=rule)
    got = K._launch_bert_attn_rev(lib, *a32, s32, p32, h, hd, BERT_EPS,
                                  flags, None)
    args = (h, hd, BERT_EPS, mxu, attn, rule)
    want64 = bmath.bert_attn_rev_core_plain(*a64, p64, *args, saved=s64)
    want32 = bmath.bert_attn_rev_core_plain(*a32, p32, *args, saved=s32)
    for k, p, q, name in zip(got, want32, want64, ["g_in", "R_in", "gc"]):
        _f32_rule(k, p, q, name)


# S=150 spans five 32-row query tiles and three streamed 64-key tiles of
# B9's row pass, the last of each ragged; the masks cut the samples inside
# the last key tile and inside the second
BERT_TILE_SHAPES = [(2, 150, 1, 64, 32), (2, 150, 2, 8, 24)]


# ---------------------------------------------------------------------------
# B4 / B5 in the product modes of the tensor-parallel presets
# ---------------------------------------------------------------------------

# (attn_mxu, rule_mxu) of the presets where they differ from exact FP32
ATTN_MODES = {"production": ("float32", "bfloat16"),
              "bfloat16": ("bfloat16", "bfloat16")}


# n = 2·64 + 5 spans three of B4's 64-row query tiles, the last ragged, in
# one 256-key score tile (the softmax in registers); n = 256 + 5 spans two
# key tiles (the softmax pass over shared memory); hd 8 leaves most of the
# 64 padded columns zero
B4_TILE_SHAPES = [(1, 2 * 64 + 5, 2, 64), (2, 2 * 64 + 5, 3, 8),
                  (1, 256 + 5, 1, 8)]


# B5's mode pairs beyond exact FP32: the presets' and the pair no preset
# runs (bf16 gradient products, float32 rules), which rounds the operands
# its products share as they are loaded
B5_MODES = {**ATTN_MODES, "bf16-attn-f32-rule": ("bfloat16", "float32")}


# ---------------------------------------------------------------------------
# Tensor-parallel MLP reverse B10a / B10b (float32 kernels against float64
# plain versions), at one shard's widths
# ---------------------------------------------------------------------------

# (B, n, D, M/k); the third: a ragged last row tile (133 = 128 + 5 rows),
# D and M/k multiples of 8 but of no tile width, and K deeper than the
# rings of the fused passes (D = 136 > 2 stages of 64, M/k = 264 > 4)
TP_SHAPES = [(2, 13, 16, 24), (1, 37, 24, 40), (1, 133, 136, 264)]


# ---------------------------------------------------------------------------
# The split path's MLP reverse B6 (float32 kernel against float64 plain
# versions), in its two product-mode pairs
# ---------------------------------------------------------------------------

MLP_SHAPES = [(2, 13, 16, 40), (1, 37, 24, 96)]     # (B, n, D, M)
# (weight preparation and MLP mode, rule mode)
MLP_MODES = [("bfloat16", "bfloat16"), ("tensorfloat32", "bfloat16")]


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


# ---------------------------------------------------------------------------
# The modes that predate bf16×3, bitwise: B4 (float32, bf16) and B5 (its
# four pairs) in float64 and float32, B2 / B3 and B9 in the presets' modes
# (float32), on fixed small inputs. ``tests/golden/torch_emulated_modes.npz``
# holds a checkout's (experiments/torch_emulated_golden.py writes it from
# the sources that predate the bf16×3 instances), so a change to the shared
# tile or passes that moves a bit of these outputs shows
# ---------------------------------------------------------------------------

def mode_outputs(lib):
    """{name: float array} of the kernels' outputs in the modes above."""
    out = {}
    b, n, h, d = SHAPES[0]
    qkv = _randn(60, b, n, 3 * h * d) + 1.0
    g_o, cam_o = _randn(61, b, n, h * d), _randn(62, b, n, h * d)
    pairs = [("float32", "float32"), *ATTN_MODES.values(),
             B5_MODES["bf16-attn-f32-rule"]]
    for dt in (torch.float64, torch.float32):
        args = tuple(t.to(dt) for t in (qkv, g_o, cam_o))
        for m in ("float32", "bfloat16"):
            out[f"B4 {m} {dt}"] = K._launch_attn_fwd(
                lib, args[0], h, d, d ** -0.5, None, K._ATTN_MODE[m])
        for a, r in pairs:
            for k, t in enumerate(K._launch_attn_rev(
                    lib, *args, h, d, d ** -0.5, None, K._ATTN_MODE[a],
                    K._ATTN_MODE[r])):
                out[f"B5 {a} {r} {dt} {k}"] = t
    b, n, h, hd = BLOCK_SHAPES[1]
    for preset, (mxu, attn, rule, mlp) in PRESETS.items():
        _, p32, x = _block_case(63, b, n, h, hd, mxu)
        fwd = K._launch_block_fwd(lib, x.float(), p32, h, hd, EPS,
                                  K._block_modes("block_fwd_core", p32,
                                                 mxu=mxu, mlp=mlp or mxu,
                                                 attn_mode=attn), None)
        rng = np.random.RandomState(64)
        g_out, R = (torch.from_numpy(rng.randn(*x.shape)).float()
                    for _ in range(2))
        rev = K._launch_block_rev(
            lib, x.float(), fwd[1], fwd[2], g_out, R, fwd[3:], p32, h, hd,
            EPS, K._block_modes("block_rev_core", p32, mxu=mxu,
                                mlp=mlp or mxu, rule=rule, attn_mode=attn,
                                rule_mode=rule), None)
        for k, t in enumerate(fwd + rev):
            out[f"B2/B3 {preset} {k}"] = t
        shape = BERT_SHAPES[2]
        bb, S, hh, dd, inter = shape
        p64, p32, xb, mask = _bert_case(65, *shape, mxu)
        fwd = bmath.bert_layer_fwd_core_plain(xb, mask, p64, hh, dd,
                                              BERT_EPS, mxu, attn, mlp,
                                              save_attn=True)
        g_attln, R_att = (torch.from_numpy(rng.randn(*xb.shape)).float()
                          for _ in range(2))
        for k, t in enumerate(K._launch_bert_attn_rev(
                lib, xb.float(), g_attln, R_att, mask.float(),
                tuple(s.float() for s in fwd[2:]), p32, hh, dd, BERT_EPS,
                K._block_modes("bert_attn_rev_core", p32, mxu=mxu, rule=rule,
                               attn_mode=attn, rule_mode=rule), None)):
            out[f"B9 {preset} {k}"] = t
    return {k: v.numpy() for k, v in out.items()}
