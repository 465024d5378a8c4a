"""The CUDA kernel sources themselves, run on the CPU: the bf16×3 MLP
products of B7, B8 and B10a (ROADMAP C8).

With a ``tensorfloat32`` base, a ``float32`` attention island and a
``bfloat16`` rule island (``production`` without its MLP island), B7's and
B8's MLP products and B10a's run in bf16×3; since C8 they sum each chain a
64-deep k-step at a time (``csrc/gemm.cuh: gemm_mlp``, the mode B2, B3 and
B6 take since C5). Each kernel is held to its plain PyTorch version in that
configuration through ``tests/cuda_emulator`` (see
``test_torch_kernels_emulated_bert.py``): B7's forward by the float32 rule
of ``chip_smoke.py``, the reverses by its drawn form (the plain float32
version on the inputs as they are and on ulp-moved copies), at one small
shape each, on the emulated library the other emulated files share
(``torch_emulator_common.lib``, built once). The other modes' outputs
stay bitwise the parent's (``tests/golden/torch_emulated_modes.npz``,
held in ``test_torch_kernels_emulated_tf32.py``).
"""

import numpy as np
import pytest
import torch

from transformer_explainability_torch.ops import bert_math as bmath
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as P
from transformer_explainability_torch.ops import relprop as rp

from torch_emulator_common import (  # noqa: F401 (lib: a fixture)
    lib, BERT_EPS, BERT_SHAPES, EPS, TP_SHAPES, _bert_case, _f32_drawn,
    _f32_rule)

# (mxu, attn_mxu, rule_mxu, mlp_mxu): the MLP products take the base's mode
C8 = ("tensorfloat32", "float32", "bfloat16", "tensorfloat32")


def test_bert_fwd_c8_matches_plain(lib):
    b, S, h, hd, inter = BERT_SHAPES[1]
    mxu, attn, _, mlp = C8
    p64, p32, x, mask = _bert_case(40, b, S, h, hd, inter, mxu)
    flags = K._block_modes("bert_layer_fwd_core", p32, mxu=mxu, mlp=mlp,
                           attn_mode=attn)
    got = K._launch_bert_fwd(lib, x.float(), mask.float(), p32, h, hd,
                             BERT_EPS, flags, None)
    args = (h, hd, BERT_EPS, mxu, attn, mlp)
    want64 = bmath.bert_layer_fwd_core_plain(x, mask, p64, *args,
                                             save_attn=True)
    want32 = bmath.bert_layer_fwd_core_plain(x.float(), mask.float(), p32,
                                             *args, save_attn=True)
    for k, p, q, name in zip(got, want32, want64, ["out", "att_ln", "qkv_pre",
                                                   "ctx", "dense_nb"]):
        _f32_rule(k, p, q, name)


def test_bert_out_rev_c8_matches_plain(lib):
    b, S, h, hd, inter = BERT_SHAPES[1]
    mxu, _, rule, mlp = C8
    p64, p32, x, _ = _bert_case(41, b, S, h, hd, inter, mxu)
    rng = np.random.RandomState(42)
    # att_ln around 4: the add rule divides by the output, near 0 any
    # float32 run is a draw of that divide (c8_measurement's inputs)
    a64 = (torch.from_numpy(4.0 + 0.5 * rng.randn(*x.shape)),
           *(torch.from_numpy(rng.randn(*x.shape)) for _ in range(2)))
    a32 = tuple(t.float() for t in a64)
    flags = K._block_modes("bert_out_rev_core", p32, mlp=mlp, rule=rule)
    got = K._launch_bert_out_rev(lib, *a32, p32, BERT_EPS, flags, None)
    want64 = bmath.bert_out_rev_core_plain(*a64, p64, BERT_EPS, mxu, rule,
                                           mlp)
    _f32_drawn(got, lambda *a: bmath.bert_out_rev_core_plain(
        *a, p32, BERT_EPS, mxu, rule, mlp), a32, want64,
        ["g_attln", "R_att"])


def test_mlp_rev_tp_c8_matches_plain(lib):
    b, n, D, Ml = TP_SHAPES[1]
    base, _, rule, mlp = C8
    rng = np.random.RandomState(43)
    w1, w2 = (P.prepare_weight(torch.from_numpy(rng.randn(o, i) / np.sqrt(i)),
                               base) for o, i in ((Ml, D), (D, Ml)))
    vecs64 = [torch.from_numpy(c + 0.1 * rng.randn(k))
              for c, k in ((1.0, D), (0.0, D), (0.0, Ml))]
    vecs32 = [v.float() for v in vecs64]
    a64 = (torch.from_numpy(rng.randn(b, n, D) + 0.5),
           torch.from_numpy(rng.randn(b, n, D)))
    a32 = tuple(t.float() for t in a64)
    flags = K._tp_modes("mlp_rev_tp_phase1", a32[0], (w1, w2), mlp=mlp,
                        rule=rule)
    got = K._launch_mlp_rev_tp1(lib, *a32, *vecs32, w1, w2, EPS, flags, None)
    want64 = K.mlp_rev_tp_phase1_plain(*a64, *vecs64, w1, w2, EPS, mlp, rule)
    want32 = K.mlp_rev_tp_phase1_plain(*a32, *vecs32, w1, w2, EPS, mlp, rule)
    for k, p, q, name in zip(got, want32, want64,
                             ["fc1_pre", "fc2_pre", "axw2", "g_xn2"]):
        _f32_rule(k, p, q, name)
    # phase 2 from the float64 phase 1's anchor, the divide as the TP
    # program forms it
    Sr = rp.safe_divide(torch.from_numpy(rng.randn(b, n, D)),
                        0.5 * (want64[1] + want64[2]))
    b64 = (a64[0], Sr, want64[0])
    b32 = tuple(t.float() for t in b64)
    got = K._launch_mlp_rev_tp2(lib, *b32, *vecs32, w1, w2, EPS,
                                {"rule": flags["rule"]}, None)
    want64 = K.mlp_rev_tp_phase2_plain(*b64, *vecs64, w1, w2, EPS, rule)
    _f32_drawn(got, lambda *a: K.mlp_rev_tp_phase2_plain(
        *a, *vecs32, w1, w2, EPS, rule), b32, want64, ["num_w", "num_a"])
