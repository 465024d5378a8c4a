"""The CUDA kernel sources themselves, run on the CPU.

``tests/cuda_emulator`` compiles ``transformer_explainability_torch/csrc/*.cu``
as plain C++ with g++ (threads for CUDA threads, barriers for
``__syncthreads``/``__syncwarp``/warp shuffles) and the tests call the same
host launchers the wrappers call, through ``ctypes``, on CPU tensors. Each
kernel is held to its plain PyTorch version: float64 at rtol 1e-9 /
atol 1e-12, float32 (forward only; the reverse's safe-divide chains make
float32 ill-posed) at rtol 1e-5 / atol 1e-6. This checks the kernels'
indexing, tiling, masking of ragged edges and reductions; timing, the
memory model and the compiler of the card are only checked on the card
(``chip_smoke.py``).
"""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from transformer_explainability_torch.ops import _build
from transformer_explainability_torch.ops import kernels as K

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emulator")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the CUDA emulator")
    out = tmp_path_factory.mktemp("emu") / "libte_emulated.so"
    cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
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
