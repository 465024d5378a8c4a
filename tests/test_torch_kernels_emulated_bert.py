"""The CUDA kernel sources themselves, run on the CPU: the BERT layer kernels
B7, B8 and B9.

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

from transformer_explainability_torch.ops import bert_math as bmath
from transformer_explainability_torch.ops import kernels as K

from torch_emulator_common import (  # noqa: F401 (lib: a fixture)
    lib, PRESETS, _f32_rule, BERT_EPS, BERT_SHAPES, _bert_case,
    _check_bert_fwd, _check_bert_attn_rev, BERT_TILE_SHAPES)


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


@pytest.mark.parametrize("shape", BERT_SHAPES)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bert_attn_rev_kernel_matches_plain(lib, shape, preset):
    _check_bert_attn_rev(lib, shape, preset)


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
