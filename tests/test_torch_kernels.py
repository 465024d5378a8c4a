"""The port's kernel wrappers and their plain versions, on the CPU.

The plain versions (the CPU path of every wrapper, and the reference the
CUDA kernels are checked against on the card) are held to the JAX functions
in float64 at rtol 1e-9 / atol 1e-12, at a ragged small shape (n=29, h=3,
hd=8, B=2). The JAX side runs two ways: its jnp path and the Pallas kernel
in interpret mode. float64 because the safe-divide chains turn 1-ulp float32
differences into ~1e-3.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_torch.ops import kernels as K

RTOL, ATOL = 1e-9, 1e-12
B, N, H, HD = 2, 29, 3, 8
SCALE = HD ** -0.5


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, 3 * H * HD), rng.randn(B, N, H * HD),
            rng.randn(B, N, H * HD))


def _jax_fwd(qkv, way):
    if way == "jnp":
        return pk._attn_fwd_core_jnp(jnp.asarray(qkv), H, HD, SCALE)
    return pk.attn_fwd_core(jnp.asarray(qkv), H, HD, SCALE, use_pallas=True,
                            interpret=True)


def _jax_rev(qkv, g_o, cam_o, way):
    args = (jnp.asarray(qkv), jnp.asarray(g_o), jnp.asarray(cam_o))
    if way == "jnp":
        return pk._attn_rev_core_jnp(*args, H, HD, SCALE)
    return pk.attn_rev_core(*args, H, HD, SCALE, use_pallas=True,
                            interpret=True)


@pytest.mark.parametrize("way", ["jnp", "interpret"])
def test_attn_fwd_core_plain_matches_jax(x64, way):
    qkv, _, _ = _inputs(0)
    got = K.attn_fwd_core_plain(torch.from_numpy(qkv), H, HD, SCALE)
    for i in range(B):
        _close(got[i], _jax_fwd(qkv[i], way))


@pytest.mark.parametrize("way", ["jnp", "interpret"])
def test_attn_rev_core_plain_matches_jax(x64, way):
    qkv, g_o, cam_o = _inputs(1)
    got = K.attn_rev_core_plain(torch.from_numpy(qkv), torch.from_numpy(g_o),
                                torch.from_numpy(cam_o), H, HD, SCALE)
    for i in range(B):
        want = _jax_rev(qkv[i], g_o[i], cam_o[i], way)
        for g, w, name in zip(got, want, ["g_qkv", "cam_qkv", "gc"]):
            _close(g[i], w, name)


@pytest.mark.parametrize("start_layer", [0, 1, 3])
@pytest.mark.parametrize("row_normalize", [False, True])
def test_rollout_plain_matches_jax(x64, start_layer, row_normalize):
    rng = np.random.RandomState(2)
    cams = np.abs(rng.randn(B, 4, N, N)) * 0.05     # (B, L, n, n) pre-reduced
    got = K.rollout_plain(torch.from_numpy(cams), start_layer, row_normalize)
    for i in range(B):
        _close(got[i], pk.rollout_from_grad_cam(
            jnp.asarray(cams[i]), None, start_layer, row_normalize,
            use_pallas=False))


@pytest.mark.parametrize("start_layer", [0, 1, 3])
@pytest.mark.parametrize("row_normalize", [False, True])
def test_rollout_plain_matches_pallas_interpret(start_layer, row_normalize):
    """The Pallas rollout computes in float32 whatever its input
    (pallas_kernels.py:86,101), so this way compares in float32, at the
    tolerance of the JAX package's own rollout kernel test."""
    rng = np.random.RandomState(2)
    cams = (np.abs(rng.randn(B, 4, N, N)) * 0.05).astype(np.float32)
    got = K.rollout_plain(torch.from_numpy(cams), start_layer, row_normalize)
    for i in range(B):
        want = pk.rollout_from_grad_cam(
            jnp.asarray(cams[i]), None, start_layer, row_normalize,
            use_pallas=True, interpret=True)
        np.testing.assert_allclose(np.asarray(got[i]), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_grads", [False, True])
@pytest.mark.parametrize("start_layer,row_normalize", [(0, False), (2, True)])
def test_rollout_per_head_form_matches_jax(x64, with_grads, start_layer,
                                           row_normalize):
    """The (B, L, h, n, n) form: head mean of (grads ⊙ cams)⁺ (or cams⁺),
    then the chain, against the jnp branch of the JAX function."""
    rng = np.random.RandomState(5)
    cams = rng.randn(B, 4, H, N, N) * 0.1
    grads = rng.randn(B, 4, H, N, N) if with_grads else None
    got = K.rollout_from_grad_cam(
        torch.from_numpy(cams), start_layer, row_normalize,
        grads=None if grads is None else torch.from_numpy(grads))
    assert torch.equal(got, K.rollout_plain(
        torch.from_numpy(cams), start_layer, row_normalize,
        None if grads is None else torch.from_numpy(grads)))
    for i in range(B):
        _close(got[i], pk.rollout_from_grad_cam(
            jnp.asarray(cams[i]), None if grads is None
            else jnp.asarray(grads[i]), start_layer, row_normalize,
            use_pallas=False))
    with pytest.raises(ValueError):
        K.rollout_from_grad_cam(torch.from_numpy(cams[:, 0]), 0,
                                grads=torch.from_numpy(cams[:, 0]))


def test_wrappers_take_plain_path_on_cpu():
    qkv, g_o, cam_o = (torch.from_numpy(a) for a in _inputs(3))
    before = K.launch_counts()
    torch.testing.assert_close(K.attn_fwd_core(qkv, H, HD, SCALE),
                               K.attn_fwd_core_plain(qkv, H, HD, SCALE),
                               rtol=0, atol=0)
    for g, w in zip(K.attn_rev_core(qkv, g_o, cam_o, H, HD, SCALE),
                    K.attn_rev_core_plain(qkv, g_o, cam_o, H, HD, SCALE)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    cams = torch.rand(B, 3, N, N, dtype=torch.float64)
    torch.testing.assert_close(K.rollout_from_grad_cam(cams, 1),
                               K.rollout_plain(cams, 1), rtol=0, atol=0)
    assert K.launch_counts() == before      # no kernel launched on the CPU


def test_wrappers_reject_bad_inputs():
    qkv, g_o, cam_o = (torch.from_numpy(a) for a in _inputs(4))
    with pytest.raises(TypeError):
        K.attn_fwd_core(qkv.to(torch.float16), H, HD, SCALE)
    with pytest.raises(TypeError):
        K.attn_rev_core(qkv, g_o.float(), cam_o, H, HD, SCALE)
    with pytest.raises(ValueError):
        K.attn_fwd_core(qkv[:, :, :-1].contiguous(), H, HD, SCALE)
    with pytest.raises(ValueError):
        K.attn_fwd_core(qkv[0], H, HD, SCALE)
    with pytest.raises(ValueError):
        K.attn_rev_core(qkv, g_o[:, :-1].contiguous(), cam_o, H, HD, SCALE)
    with pytest.raises(ValueError):             # non-contiguous
        K.attn_fwd_core(qkv.transpose(0, 1).contiguous().transpose(0, 1),
                        H, HD, SCALE)
    with pytest.raises(ValueError):
        K.attn_rev_core(torch.zeros(1, 3, 3 * 128), torch.zeros(1, 3, 128),
                        torch.zeros(1, 3, 128), 1, 128, 1.0)
    cams = torch.rand(B, 3, N, N, dtype=torch.float64)
    with pytest.raises(ValueError):
        K.rollout_from_grad_cam(cams[..., :-1], 0)
    with pytest.raises(ValueError):
        K.rollout_from_grad_cam(cams, 3)
    with pytest.raises(ValueError):
        K.rollout_from_grad_cam(cams.transpose(2, 3), 0)
    with pytest.raises(TypeError):
        K.rollout_from_grad_cam(cams.to(torch.int32), 0)


def test_import_and_nvcc_command_need_no_cuda(tmp_path):
    """Importing the port and building the nvcc command line must work on a
    machine with no CUDA, no nvcc and no JAX (checked in a fresh process
    with JAX made unimportable)."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None           # any jax import now fails
        import transformer_explainability_torch as te
        from transformer_explainability_torch.ops import _build, kernels
        from pathlib import Path
        cmds = _build.compile_commands(Path("obj"))
        assert len(cmds) == len(_build.sources()) >= 5
        for cmd in cmds:
            assert "arch=compute_90a,code=sm_90a" in cmd, cmd
            assert cmd[-1].endswith(".cu") and "-c" in cmd, cmd
        link = _build.link_command(Path("out.so"), ["a.o", "b.o"])
        assert "-shared" in link and link[-2:] == ["a.o", "b.o"], link
        assert _build.library_path().parent.parent == _build.BUILD_ROOT
        print("ok", len(_build.source_hash()))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path),
                         env={"PYTHONPATH": str(K.__file__).rsplit(
                             "/transformer_explainability_torch", 1)[0],
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok 16"


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from transformer_explainability_torch import Explainer, ViTConfig
    cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=8, depth=1,
                    num_heads=2, num_classes=3)
    with pytest.raises(RuntimeError):
        Explainer({}, cfg, device="cuda")
