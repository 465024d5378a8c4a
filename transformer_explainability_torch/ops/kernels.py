"""Wrappers of the hand-written CUDA kernels, each with its plain version.

Port of the three Pallas kernels on the exact-FP32 ``transformer_attribution``
path of ``transformer_explainability_tpu/ops/pallas_kernels.py``:

  ============================  ==========================  ==================
  wrapper                       TPU kernel                  CUDA source
  ============================  ==========================  ==================
  ``attn_fwd_core``             ``attn_fwd_core``           ``csrc/attn_fwd.cu``
  ``attn_rev_core``             ``attn_rev_core``           ``csrc/attn_rev.cu``
  ``rollout_from_grad_cam``     ``rollout_from_grad_cam``   ``csrc/rollout.cu``
  ============================  ==========================  ==================

Each wrapper checks device, dtype (float32 or float64), shape and
contiguity, and raises on anything its kernel does not take. For a CPU
tensor it runs its plain PyTorch version (``*_plain``, the counterpart of
the JAX package's jnp paths); for a CUDA tensor it launches the kernel on
``torch.cuda.current_stream()`` or raises, and adds one to its ``launches``
count. It never falls back from the kernel to the plain version.

Layouts follow the JAX package, with a leading batch dimension: ``qkv`` is
``(B, n, 3D)`` with columns in ``'n (qkv h d)'`` order, ``g_qkv`` and
``cam_qkv`` come back in that layout, and the rollout takes pre-reduced
``(B, L, n, n)`` maps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from transformer_explainability_torch.ops import relprop as rp

Tensor = torch.Tensor

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
MAX_HEAD_DIM = 64        # attn_rev's column pass keeps ≤ 8 columns a thread


# ---------------------------------------------------------------------------
# Plain versions (JAX: _attn_fwd_core_jnp, _attn_rev_core_jnp and the jnp
# branch of rollout_from_grad_cam)
# ---------------------------------------------------------------------------

def _split_heads(qkv: Tensor, num_heads: int, head_dim: int):
    """(B, n, 3D) -> three (B, h, n, hd) views."""
    b, n, _ = qkv.shape
    x = qkv.reshape(b, n, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _merge_heads(x: Tensor) -> Tensor:
    """(B, h, n, hd) -> (B, n, h*hd)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _merge3(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """Three (B, h, n, hd) -> (B, n, 3·h·hd) in 'n (qkv h d)' order."""
    x = torch.stack([a, b, c], dim=2)                    # (B, h, 3, n, hd)
    bsz, h, _, n, d = x.shape
    return x.permute(0, 3, 2, 1, 4).reshape(bsz, n, 3 * h * d)


def attn_fwd_core_plain(qkv: Tensor, num_heads: int, head_dim: int,
                        scale: float) -> Tensor:
    q, k, v = _split_heads(qkv, num_heads, head_dim)
    dots = q @ k.transpose(-1, -2)
    attn = torch.softmax(dots * scale, dim=-1)
    return _merge_heads(attn @ v)


def attn_rev_core_plain(qkv: Tensor, g_o: Tensor, cam_o: Tensor,
                        num_heads: int, head_dim: int,
                        scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    b, n, _ = qkv.shape
    q, k, v = _split_heads(qkv, num_heads, head_dim)
    go = g_o.reshape(b, n, num_heads, head_dim).transpose(1, 2)
    co = cam_o.reshape(b, n, num_heads, head_dim).transpose(1, 2)
    dots = q @ k.transpose(-1, -2)
    attn = torch.softmax(dots * scale, dim=-1)
    out = attn @ v
    g_attn = go @ v.transpose(-1, -2)
    g_v = attn.transpose(-1, -2) @ go
    inner = (g_attn * attn).sum(dim=-1, keepdim=True)
    g_dots = attn * (g_attn - inner) * scale
    g_q = g_dots @ k
    g_k = g_dots.transpose(-1, -2) @ q
    S1 = rp.safe_divide(co, out)
    cam1 = attn * (S1 @ v.transpose(-1, -2)) * 0.5
    cam_v = v * (attn.transpose(-1, -2) @ S1) * 0.5
    S2 = rp.safe_divide(cam1, dots)          # pre-scale dots
    cam_q = q * (S2 @ k) * 0.5
    cam_k = k * (S2.transpose(-1, -2) @ q) * 0.5
    gc = (g_attn * cam1).clamp(min=0).mean(dim=1)
    return _merge3(g_q, g_k, g_v), _merge3(cam_q, cam_k, cam_v), gc


def rollout_plain(cams: Tensor, start_layer: int = 0,
                  row_normalize: bool = False) -> Tensor:
    return rp.compute_rollout(cams, start_layer, row_normalize)


# ---------------------------------------------------------------------------
# Checks and launches
# ---------------------------------------------------------------------------

def _check(name: str, tensors, shapes) -> str:
    """Validate the inputs of one wrapper; returns the device type."""
    ref = tensors[0]
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported "
                        "(float32 or float64)")
    for t, shape in zip(tensors, shapes):
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: mixed dtypes {ref.dtype} and {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name}: mixed devices {ref.device} and "
                             f"{t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input must be contiguous")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: device {ref.device} not supported")
    return ref.device.type


def _raise_on_error(name: str, lib, code: int) -> None:
    if code != 0:
        msg = lib.te_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed ({code}: "
                           f"{msg})")


def _stream(t: Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib():
    from transformer_explainability_torch.ops._build import load_library
    return load_library()


def _launch_attn_fwd(lib, qkv: Tensor, num_heads: int, head_dim: int,
                     scale: float, stream) -> Tensor:
    b, n, _ = qkv.shape
    out = torch.empty(b, n, num_heads * head_dim, dtype=qkv.dtype,
                      device=qkv.device)
    fn = getattr(lib, f"te_attn_fwd_{_DTYPES[qkv.dtype]}")
    _raise_on_error("attn_fwd_core", lib, fn(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, head_dim,
        float(scale), stream))
    return out


def _launch_attn_rev(lib, qkv: Tensor, g_o: Tensor, cam_o: Tensor,
                     num_heads: int, head_dim: int, scale: float, stream):
    b, n, d3 = qkv.shape
    kw = dict(dtype=qkv.dtype, device=qkv.device)
    g_qkv = torch.empty(b, n, d3, **kw)
    cam_qkv = torch.empty(b, n, d3, **kw)
    gc = torch.empty(b, n, n, **kw)
    # scratch: attn, g_dots, S2, per-head (g_attn ⊙ cam1)⁺, S1
    P, G, S2, GCP = (torch.empty(b, num_heads, n, n, **kw) for _ in range(4))
    S1 = torch.empty(b, num_heads, n, head_dim, **kw)
    fn = getattr(lib, f"te_attn_rev_{_DTYPES[qkv.dtype]}")
    _raise_on_error("attn_rev_core", lib, fn(
        qkv.data_ptr(), g_o.data_ptr(), cam_o.data_ptr(), g_qkv.data_ptr(),
        cam_qkv.data_ptr(), gc.data_ptr(), P.data_ptr(), G.data_ptr(),
        S2.data_ptr(), GCP.data_ptr(), S1.data_ptr(), b, n, num_heads,
        head_dim, float(scale), stream))
    return g_qkv, cam_qkv, gc


def _launch_rollout(lib, cams: Tensor, start_layer: int, row_normalize: bool,
                    stream) -> Tensor:
    b, L, n, _ = cams.shape
    kw = dict(dtype=cams.dtype, device=cams.device)
    out = torch.empty(b, n, n, **kw)
    buf = torch.empty(b, n, n, **kw)
    rs = torch.empty(b, L, n, **kw) if row_normalize else None
    fn = getattr(lib, f"te_rollout_{_DTYPES[cams.dtype]}")
    _raise_on_error("rollout_from_grad_cam", lib, fn(
        cams.data_ptr(), out.data_ptr(), buf.data_ptr(),
        None if rs is None else rs.data_ptr(), b, L, n, start_layer,
        int(row_normalize), stream))
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def attn_fwd_core(qkv: Tensor, num_heads: int, head_dim: int,
                  scale: float) -> Tensor:
    """Softmax attention from raw ``qkv (B, n, 3D)`` -> merged ``(B, n, D)``
    (JAX ``pallas_kernels.attn_fwd_core``)."""
    D = num_heads * head_dim
    b, n = qkv.shape[:2] if qkv.ndim == 3 else (-1, -1)
    device = _check("attn_fwd_core", [qkv], [(b, n, 3 * D)])
    if device == "cpu":
        return attn_fwd_core_plain(qkv, num_heads, head_dim, scale)
    with torch.cuda.device(qkv.device):
        out = _launch_attn_fwd(_lib(), qkv, num_heads, head_dim, scale,
                               _stream(qkv))
    attn_fwd_core.launches += 1
    return out


def attn_rev_core(qkv: Tensor, g_o: Tensor, cam_o: Tensor, num_heads: int,
                  head_dim: int, scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused backward + LRP relprop of the attention core (JAX
    ``pallas_kernels.attn_rev_core``). ``qkv (B, n, 3D)``; ``g_o``,
    ``cam_o (B, n, D)`` are the merged-head gradient and relevance at the
    AV output. Returns ``(g_qkv (B, n, 3D), cam_qkv (B, n, 3D),
    gc (B, n, n))``: the qkv-layout cotangent and relevance, and the
    head-mean ``(grad ⊙ cam)⁺`` map."""
    D = num_heads * head_dim
    b, n = qkv.shape[:2] if qkv.ndim == 3 else (-1, -1)
    device = _check("attn_rev_core", [qkv, g_o, cam_o],
                    [(b, n, 3 * D), (b, n, D), (b, n, D)])
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"attn_rev_core: head_dim {head_dim} > "
                         f"{MAX_HEAD_DIM} is not supported by the kernel")
    if device == "cpu":
        return attn_rev_core_plain(qkv, g_o, cam_o, num_heads, head_dim,
                                   scale)
    with torch.cuda.device(qkv.device):
        outs = _launch_attn_rev(_lib(), qkv, g_o, cam_o, num_heads, head_dim,
                                scale, _stream(qkv))
    attn_rev_core.launches += 1
    return outs


def rollout_from_grad_cam(cams: Tensor, start_layer: int = 0,
                          row_normalize: bool = False) -> Tensor:
    """Rollout chain ``Π_{i=L-1..start} (I + cams_i)`` over pre-reduced
    ``(B, L, n, n)`` maps -> ``(B, n, n)`` (JAX
    ``pallas_kernels.rollout_from_grad_cam`` with 3-d ``cams``)."""
    if cams.ndim != 4 or cams.shape[-1] != cams.shape[-2]:
        raise ValueError(f"rollout_from_grad_cam: cams must be (B, L, n, n),"
                         f" got {tuple(cams.shape)}")
    device = _check("rollout_from_grad_cam", [cams], [cams.shape])
    if not 0 <= start_layer < cams.shape[1]:
        raise ValueError(f"rollout_from_grad_cam: start_layer {start_layer} "
                         f"outside [0, {cams.shape[1]})")
    if device == "cpu":
        return rollout_plain(cams, start_layer, row_normalize)
    with torch.cuda.device(cams.device):
        out = _launch_rollout(_lib(), cams, start_layer, row_normalize,
                              _stream(cams))
    rollout_from_grad_cam.launches += 1
    return out


attn_fwd_core.launches = 0
attn_rev_core.launches = 0
rollout_from_grad_cam.launches = 0

WRAPPERS = (attn_fwd_core, attn_rev_core, rollout_from_grad_cam)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


class AttnOps(NamedTuple):
    """The three operations the ViT path calls, so that a reference run can
    take the plain versions explicitly on any device."""
    attn_fwd_core: Callable
    attn_rev_core: Callable
    rollout_from_grad_cam: Callable


KERNEL_OPS = AttnOps(attn_fwd_core, attn_rev_core, rollout_from_grad_cam)
PLAIN_OPS = AttnOps(attn_fwd_core_plain, attn_rev_core_plain, rollout_plain)
