"""The CUDA kernel sources themselves, run on the CPU: the attention kernels B4
and B5 and the rollout B1.

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

import pytest
import torch

from transformer_explainability_torch.ops import kernels as K

from torch_emulator_common import (  # noqa: F401 (lib: a fixture)
    lib, _randn, SHAPES, B5_SHAPES, _check_attn_rev, _check_rollout,
    _f32_rule, B4_TILE_SHAPES, B5_MODES)


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


@pytest.mark.parametrize("shape", B5_SHAPES)
def test_attn_rev_kernel_matches_plain(lib, shape):
    _check_attn_rev(lib, shape, "float32", "float32", (1, 2, 3))


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


@pytest.mark.parametrize("shape", SHAPES)
def test_attn_fwd_kernel_bf16_matches_plain(lib, shape):
    """float64 at rtol 1e-9 (both round the same operands to bf16), and
    float32 by the rule above."""
    b, n, h, d = shape
    qkv = _randn(40, b, n, 3 * h * d)
    flag = K._ATTN_MODE["bfloat16"]
    got = K._launch_attn_fwd(lib, qkv, h, d, d ** -0.5, None, flag)
    want = K.attn_fwd_core_plain(qkv, h, d, d ** -0.5, "bfloat16")
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    got32 = K._launch_attn_fwd(lib, qkv.float(), h, d, d ** -0.5, None, flag)
    _f32_rule(got32, K.attn_fwd_core_plain(qkv.float(), h, d, d ** -0.5,
                                           "bfloat16"), want, "out")


@pytest.mark.parametrize("shape", B4_TILE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", sorted(K._ATTN_MODE))
def test_attn_fwd_kernel_tiles_match_plain(lib, shape, dtype, mode):
    """float64 at rtol 1e-9; float32 by the rule above, in the bf16 modes
    against the plain float32 version within one re-rounding: an ulp
    between two float32 probabilities can round them to bf16 values 2⁻⁸
    apart, which moves an output by up to 2⁻⁸·max|v|, and at this size
    whether the kernel or the plain version meets such a tie is a draw; in
    bf16×3 the hi and lo parts of a probability sum to it within 2⁻¹⁷ of
    it, so such a flip moves an output by at most 2⁻¹⁶·max|v|."""
    b, n, h, d = shape
    qkv = _randn(44, b, n, 3 * h * d)
    flag = K._ATTN_MODE[mode]
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
            reround = 2 ** -8 if mode == "bfloat16" else 2 ** -16
            torch.testing.assert_close(got, plain32, rtol=0,
                                       atol=reround * v_max)


@pytest.mark.parametrize("shape", B5_SHAPES)
@pytest.mark.parametrize("preset", sorted(B5_MODES))
def test_attn_rev_kernel_modes_match_plain(lib, shape, preset):
    _check_attn_rev(lib, shape, *B5_MODES[preset], (41, 42, 43))
