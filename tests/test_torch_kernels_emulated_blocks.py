"""The CUDA kernel sources themselves, run on the CPU: the ViT block
megakernels B2 and B3.

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

Shared helpers and the ``lib`` fixture: ``tests/torch_emulator_common.py``.
"""

import numpy as np
import pytest
import torch

from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K

# B4's check, under a name pytest does not collect twice
from test_torch_kernels_emulated_attention import (
    test_attn_fwd_kernel_matches_plain as _attn_fwd_kernel_matches_plain)
from torch_emulator_common import (  # noqa: F401 (lib: a fixture)
    lib, EPS, PRESETS, BLOCK_SHAPES, _block_case, _f32_rule,
    BLOCK_TILE_SHAPES, _check_block_rev, DISTILLED_SHAPE)


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
                           attn_mode=attn)
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
    _check_block_rev(lib, shape, preset)


@pytest.mark.parametrize("shape", BLOCK_TILE_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_block_rev_kernel_tiles_match_plain(lib, shape, preset):
    _check_block_rev(lib, shape, preset)


@pytest.mark.parametrize("kernel", ["B4", "B2"])
def test_kernels_at_the_distilled_length_match_plain(lib, kernel):
    if kernel == "B4":
        _attn_fwd_kernel_matches_plain(lib, DISTILLED_SHAPE,
                                       torch.float64)
    else:
        test_block_fwd_kernel_matches_plain(lib, DISTILLED_SHAPE,
                                            "production")


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
                               mlp=mlp or mxu, attn_mode=attn)
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
            b, n, h, hd, hd ** -0.5, K._ATTN_MODE[attn], K._ATTN_MODE[rule],
            None)
        assert code == 0
        assert torch.equal(maps[0].view(torch.int32),
                           probs.view(torch.int32)), (b, n, h, hd)
