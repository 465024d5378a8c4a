"""Wrappers of the hand-written CUDA kernels, each with its plain version.

Port of the Pallas kernels on the ViT ``transformer_attribution`` path of
``transformer_explainability_tpu/ops/pallas_kernels.py``:

  ============================  ==========================  ===================
  wrapper                       TPU kernel                  CUDA source
  ============================  ==========================  ===================
  ``attn_fwd_core``             ``attn_fwd_core``           ``csrc/attn_fwd.cu``
  ``attn_rev_core``             ``attn_rev_core``           ``csrc/attn_rev.cu``
  ``rollout_from_grad_cam``     ``rollout_from_grad_cam``   ``csrc/rollout.cu``
  ``block_fwd_core``            ``block_fwd_core``          ``csrc/block_fwd.cu``
  ``block_rev_core``            ``block_rev_core``          ``csrc/block_rev.cu``
  ============================  ==========================  ===================

The first three carry the exact-FP32 path; the block megakernels the
``bfloat16`` / ``tensorfloat32`` presets (their plain versions are in
:mod:`.block_math`, their GEMM core is ``csrc/gemm.cuh``).

Each wrapper checks device, dtype (float32 or float64; the block kernels
take float32 on the card), shape and contiguity, and raises on anything its kernel does not take. For a CPU
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

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from transformer_explainability_torch.ops import relprop as rp
from transformer_explainability_torch.ops.block_math import (
    BlockParams, block_fwd_core_plain, block_rev_core_plain, merge3,
    merge_heads, split_heads)

Tensor = torch.Tensor

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
MAX_HEAD_DIM = 64        # attn_rev's column pass keeps ≤ 8 columns a thread


# ---------------------------------------------------------------------------
# Plain versions (JAX: _attn_fwd_core_jnp, _attn_rev_core_jnp and the jnp
# branch of rollout_from_grad_cam)
# ---------------------------------------------------------------------------

def attn_fwd_core_plain(qkv: Tensor, num_heads: int, head_dim: int,
                        scale: float) -> Tensor:
    q, k, v = split_heads(qkv, num_heads, head_dim)
    dots = q @ k.transpose(-1, -2)
    attn = torch.softmax(dots * scale, dim=-1)
    return merge_heads(attn @ v)


def attn_rev_core_plain(qkv: Tensor, g_o: Tensor, cam_o: Tensor,
                        num_heads: int, head_dim: int,
                        scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    b, n, _ = qkv.shape
    q, k, v = split_heads(qkv, num_heads, head_dim)
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
    return merge3(g_q, g_k, g_v), merge3(cam_q, cam_k, cam_v), gc


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


# product modes of the block kernels' C entry points
_GEMM_MODE = {"bfloat16": 0, "tensorfloat32": 1}
_ATTN_BF16 = {"float32": 0, "bfloat16": 1}


def _block_modes(name: str, p: BlockParams, **modes) -> dict:
    """Map the product modes to the kernels' flags; raise on a mode or a
    weight preparation the kernel does not take."""
    out = {}
    for key, mode in modes.items():
        table = _ATTN_BF16 if key.endswith("_bf16") else _GEMM_MODE
        if mode not in table:
            raise NotImplementedError(
                f"{name}: {key.replace('_bf16', '')} mode {mode!r} has no "
                f"kernel instantiation (ROADMAP B, raw tensorfloat32)")
        out[key] = table[mode]
    if p.ln1s.shape[0] % 8 or p.b1.shape[0] % 8:
        raise ValueError(f"{name}: the kernel needs the embedding and MLP "
                         "widths to be multiples of 8")
    paired = all(len(w) == 2 for w in (p.wqkv, p.wproj, p.w1, p.w2))
    if any(out.get(k) == 1 for k in ("mxu", "mlp", "rule")) and not paired:
        raise ValueError(f"{name}: a tensorfloat32 product needs weights "
                         "prepared as (hi, lo) pairs")
    return out


def _check_block_params(name: str, p: BlockParams, like: Tensor, D: int,
                        M: int) -> None:
    vecs = (p.ln1s, p.ln1b, p.ln2s, p.ln2b, p.bqkv, p.bproj, p.b1, p.b2)
    _check(name, [like, *vecs], [like.shape] + [(D,)] * 4
           + [(3 * D,), (D,), (M,), (D,)])
    for w, shape in zip((p.wqkv, p.wproj, p.w1, p.w2),
                        ((3 * D, D), (D, D), (M, D), (D, M))):
        for t in w:
            if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                    or not t.is_contiguous() or t.device != like.device):
                raise ValueError(f"{name}: prepared weights must be "
                                 f"contiguous bf16 {shape} on {like.device}")


def _weight_ptrs(p: BlockParams):
    ptrs = []
    for w in (p.wqkv, p.wproj, p.w1, p.w2):
        ptrs += [w[0].data_ptr(), w[1].data_ptr() if len(w) > 1 else None]
    return ptrs


def _vec_ptrs(p: BlockParams):
    return [t.data_ptr() for t in (p.ln1s, p.ln1b, p.ln2s, p.ln2b, p.bqkv,
                                   p.bproj, p.b1, p.b2)]


def _workspace(fn, dims, device) -> Tensor:
    """Ask an entry point for its workspace size (null workspace), then
    allocate it."""
    import ctypes
    size = ctypes.c_size_t(0)
    nulls = [None] * (len(fn.argtypes) - len(dims) - 1)
    nulls[-1] = ctypes.addressof(size)          # work_bytes
    code = fn(*nulls, *dims, None)
    if code != 0:
        raise RuntimeError(f"workspace query failed ({code})")
    return torch.empty(size.value, dtype=torch.uint8, device=device)


def _launch_block_fwd(lib, x: Tensor, p: BlockParams, num_heads: int,
                      head_dim: int, eps: float, flags: dict, stream):
    b, n, D = x.shape
    M = p.b1.shape[0]
    kw = dict(dtype=x.dtype, device=x.device)
    outs = ([torch.empty(b, n, D, **kw) for _ in range(3)]
            + [torch.empty(b, n, 3 * D, **kw), torch.empty(b, n, D, **kw),
               torch.empty(b, num_heads * n, n, **kw),
               torch.empty(b, num_heads * n, n, **kw),
               torch.empty(b, n, M, **kw), torch.empty(b, n, D, **kw)])
    fn = lib.te_block_fwd_f32
    dims = [b, n, num_heads, head_dim, M, float(eps), flags["mxu"],
            flags["attn_bf16"], flags["mlp"]]
    work = _workspace(fn, dims, x.device)
    _raise_on_error("block_fwd_core", lib, fn(
        x.data_ptr(), *_vec_ptrs(p), *_weight_ptrs(p),
        *[o.data_ptr() for o in outs], work.data_ptr(), None, *dims, stream))
    return tuple(outs)


def _launch_block_rev(lib, x_in: Tensor, x_mid: Tensor, out_m: Tensor,
                      g_out: Tensor, R: Tensor, saved, p: BlockParams,
                      num_heads: int, head_dim: int, eps: float, flags: dict,
                      stream):
    b, n, D = x_in.shape
    M = p.b1.shape[0]
    kw = dict(dtype=x_in.dtype, device=x_in.device)
    g_in, R_in = torch.empty(b, n, D, **kw), torch.empty(b, n, D, **kw)
    gc = torch.empty(b, n, n, **kw)
    fn = lib.te_block_rev_f32
    dims = [b, n, num_heads, head_dim, M, float(eps), flags["mxu"],
            flags["attn_bf16"], flags["rule_bf16"], flags["rule"],
            flags["mlp"]]
    work = _workspace(fn, dims, x_in.device)
    _raise_on_error("block_rev_core", lib, fn(
        *[t.data_ptr() for t in (x_in, x_mid, out_m, g_out, R, *saved)],
        *_vec_ptrs(p), *_weight_ptrs(p), g_in.data_ptr(), R_in.data_ptr(),
        gc.data_ptr(), work.data_ptr(), None, *dims, stream))
    return g_in, R_in, gc


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


def block_fwd_core(x: Tensor, p: BlockParams, num_heads: int,
                   head_dim: int, eps: float, mxu: str, attn_mxu: str,
                   mlp_mxu: Optional[str] = None, save_attn: bool = False,
                   save_mlp: bool = False) -> Tuple[Tensor, ...]:
    """One whole ViT block forward on ``x (B, n, D)`` (JAX
    ``pallas_kernels.block_fwd_core``); returns ``(x_out, x_mid, out_m)``
    and, with ``save_attn`` / ``save_mlp``, the rich anchors, as
    :func:`.block_math.block_fwd_core_plain`. The kernel computes every
    anchor in any case (each is an intermediate of its launches)."""
    D = num_heads * head_dim
    if x.ndim != 3 or x.shape[-1] != D:
        raise ValueError(f"block_fwd_core: x must be (B, n, {D}), got "
                         f"{tuple(x.shape)}")
    if save_mlp and not save_attn:
        raise ValueError("save_mlp requires save_attn")
    _check_block_params("block_fwd_core", p, x, D, p.b1.shape[0])
    if x.device.type == "cpu":
        return block_fwd_core_plain(x, p, num_heads, head_dim, eps, mxu,
                                    attn_mxu, mlp_mxu, save_attn, save_mlp)
    if x.dtype != torch.float32:
        raise TypeError("block_fwd_core: the kernel takes float32")
    flags = _block_modes("block_fwd_core", p, mxu=mxu, mlp=mlp_mxu or mxu,
                         attn_bf16=attn_mxu)
    with torch.cuda.device(x.device):
        outs = _launch_block_fwd(_lib(), x, p, num_heads, head_dim, eps,
                                 flags, _stream(x))
    block_fwd_core.launches += 1
    return outs[:3 + 4 * save_attn + 2 * save_mlp]


def block_rev_core(x_in: Tensor, x_mid: Tensor, out_m: Tensor, g_out: Tensor,
                   R: Tensor, p: BlockParams, num_heads: int, head_dim: int,
                   eps: float, mxu: str, attn_mxu: str, rule_mxu: str,
                   mlp_mxu: Optional[str] = None,
                   saved: Optional[Tuple[Tensor, ...]] = None
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The whole fused reverse step of one ViT block (JAX
    ``pallas_kernels.block_rev_core``, variant ``ours``, α=1): returns
    ``(g_in, R_in, gc (B, n, n))`` as
    :func:`.block_math.block_rev_core_plain`. The kernel takes the 6-anchor
    ``saved`` form of :func:`block_fwd_core`."""
    D = num_heads * head_dim
    b, n = x_in.shape[:2] if x_in.ndim == 3 else (-1, -1)
    M = p.b1.shape[0]
    _check("block_rev_core", [x_in, x_mid, out_m, g_out, R],
           [(b, n, D)] * 5)
    _check_block_params("block_rev_core", p, x_in, D, M)
    if saved is not None:
        shapes = [(b, n, 3 * D), (b, n, D), (b, num_heads * n, n),
                  (b, num_heads * n, n), (b, n, M), (b, n, D)]
        if len(saved) not in (4, 6):
            raise ValueError("block_rev_core: saved holds 4 or 6 anchors")
        _check("block_rev_core", [x_in, *saved],
               [x_in.shape] + shapes[:len(saved)])
    if x_in.device.type == "cpu":
        return block_rev_core_plain(x_in, x_mid, out_m, g_out, R, p,
                                    num_heads, head_dim, eps, mxu, attn_mxu,
                                    rule_mxu, mlp_mxu, saved)
    if x_in.dtype != torch.float32:
        raise TypeError("block_rev_core: the kernel takes float32")
    if saved is None or len(saved) != 6:
        raise NotImplementedError(
            "block_rev_core: the kernel takes the 6-anchor saved form; the "
            "recompute form is ROADMAP B (B3 recompute)")
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"block_rev_core: head_dim {head_dim} > "
                         f"{MAX_HEAD_DIM} is not supported by the kernel")
    flags = _block_modes("block_rev_core", p, mxu=mxu, mlp=mlp_mxu or mxu,
                         rule=rule_mxu, attn_bf16=attn_mxu,
                         rule_bf16=rule_mxu)
    with torch.cuda.device(x_in.device):
        outs = _launch_block_rev(_lib(), x_in, x_mid, out_m, g_out, R, saved,
                                 p, num_heads, head_dim, eps, flags,
                                 _stream(x_in))
    block_rev_core.launches += 1
    return outs


attn_fwd_core.launches = 0
attn_rev_core.launches = 0
rollout_from_grad_cam.launches = 0
block_fwd_core.launches = 0
block_rev_core.launches = 0

WRAPPERS = (attn_fwd_core, attn_rev_core, rollout_from_grad_cam,
            block_fwd_core, block_rev_core)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


class AttnOps(NamedTuple):
    """The kernel operations the ViT path calls, so that a reference run
    can take the plain versions explicitly on any device."""
    attn_fwd_core: Callable
    attn_rev_core: Callable
    rollout_from_grad_cam: Callable
    block_fwd_core: Callable
    block_rev_core: Callable


KERNEL_OPS = AttnOps(attn_fwd_core, attn_rev_core, rollout_from_grad_cam,
                     block_fwd_core, block_rev_core)
PLAIN_OPS = AttnOps(attn_fwd_core_plain, attn_rev_core_plain, rollout_plain,
                    block_fwd_core_plain, block_rev_core_plain)
