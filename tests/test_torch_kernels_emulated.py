"""The CUDA kernel sources themselves, run on the CPU.

``tests/cuda_emulator`` compiles ``transformer_explainability_torch/csrc/*.cu``
as plain C++ with g++ (threads for CUDA threads, barriers for
``__syncthreads``/``__syncwarp``/warp shuffles) and the tests call the same
host launchers the wrappers call, through ``ctypes``, on CPU tensors. Each
kernel is held to its plain PyTorch version: float64 at rtol 1e-9 /
atol 1e-12, float32 (forward only; the reverse's safe-divide chains make
float32 ill-posed) at rtol 1e-5 / atol 1e-6. The block megakernels
(float32 only) are held to their plain versions in float64 by the rule of
``chip_smoke.py``: the kernel's distance to the float64 plain result is at
most 10 × the plain float32 version's plus 1e-6 of the output's magnitude.
This checks the kernels' indexing, tiling, masking of ragged edges and reductions; timing, the
memory model and the compiler of the card are only checked on the card
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
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as P

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


@pytest.mark.parametrize("shape", SHAPES)
def test_attn_rev_kernel_matches_plain(lib, shape):
    b, n, h, d = shape
    # q, k, v offset from 0 so that the z-rule denominators (q·k, attn·v)
    # stay away from 0, where float64 summation order alone moves results
    # by more than 1e-9 (the comparison would measure conditioning)
    qkv = _randn(1, b, n, 3 * h * d) + 1.0
    g_o, cam_o = _randn(2, b, n, h * d), _randn(3, b, n, h * d)
    got = K._launch_attn_rev(lib, qkv, g_o, cam_o, h, d, d ** -0.5, None)
    want = K.attn_rev_core_plain(qkv, g_o, cam_o, h, d, d ** -0.5)
    for g, w, name in zip(got, want, ["g_qkv", "cam_qkv", "gc"]):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-12, msg=name)


@pytest.mark.parametrize("start_layer", [0, 1, 3])
@pytest.mark.parametrize("row_normalize", [False, True])
def test_rollout_kernel_matches_plain(lib, start_layer, row_normalize):
    cams = _randn(4, 2, 4, 37, 37).abs() * 0.05
    got = K._launch_rollout(lib, cams, start_layer, row_normalize, None)
    want = K.rollout_plain(cams, start_layer, row_normalize)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


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


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
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


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_block_rev_kernel_matches_plain(lib, shape, preset):
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
