"""The CUDA kernel sources themselves, run on the CPU: the MLP reverse kernels
B6, B10a and B10b and the GEMM core they run on.

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
from transformer_explainability_torch.ops import precision as P
from transformer_explainability_torch.ops import relprop as rp

from torch_emulator_common import (  # noqa: F401 (lib: a fixture)
    lib, EPS, PRESETS, _f32_rule, TP_SHAPES, MLP_SHAPES, MLP_MODES,
    CORE_INSTANCES, CORE_SHAPES, _fused_case, _core_mag,
    _check_core_bf16_instance)


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
