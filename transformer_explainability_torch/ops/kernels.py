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
  ``bert_layer_fwd_core``       ``bert_layer_fwd_core``     ``csrc/bert_fwd.cu``
  ``bert_out_rev_core``         ``bert_out_rev_core``       ``csrc/bert_out_rev.cu``
  ``bert_attn_rev_core``        ``bert_attn_rev_core``      ``csrc/bert_attn_rev.cu``
  ``mlp_rev_tp_phase1``         ``mlp_rev_tp_phase1``       ``csrc/mlp_rev_tp.cu``
  ``mlp_rev_tp_phase2``         ``mlp_rev_tp_phase2``       ``csrc/mlp_rev_tp.cu``
  ``mlp_rev_core``              ``mlp_rev_core``            ``csrc/mlp_rev.cu``
  ============================  ==========================  ===================

The first three carry the exact-FP32 ViT path; the block megakernels the
``bfloat16`` / ``tensorfloat32`` presets (their plain versions are in
:mod:`.block_math`, their GEMM core is ``csrc/gemm.cuh``); the BERT layer
kernels the BERT presets (plain versions in :mod:`.bert_math`, same GEMM
core). The rollout serves both models. The tensor-parallel explain program
(:mod:`..parallel.tensor`) runs ``attn_fwd_core`` / ``attn_rev_core`` on
each rank's heads, in the product modes of its preset, and the two TP MLP
phases (plain versions in :mod:`.tp_math`, same GEMM core). The ViT split
path (``block_kernel=False``) runs the attention kernels in the islands'
modes, at the ``bfloat16`` base with ``mlp_rev_core`` for the MLP half of
the reverse (plain version :func:`.block_math.mlp_rev_math`, same GEMM
core), at the ``tensorfloat32`` base with that plain version itself. The
attention kernels and the ViT block kernels take attention and rule
products in ``"float32"``, ``"bfloat16"`` or ``"tensorfloat32"`` (the
bf16×3 split of :func:`..ops.precision.kdot`; :data:`_ATTN_MODE`); the
BERT layer kernels in the first two (:func:`_bert_modes`).
``gemm_core`` runs that core alone (``csrc/gemm.cu``, a store epilogue),
beside its plain version :func:`gemm_core_plain`, for its checks and
timings; no path calls it.

Each wrapper checks device, dtype (float32 or float64; the block kernels
take float32 on the card), shape and contiguity, and raises on anything its kernel does not take. For a CPU
tensor it runs its plain PyTorch version (``*_plain``, the counterpart of
the JAX package's jnp paths); for a CUDA tensor it launches the kernel on
``torch.cuda.current_stream()`` or raises, and adds one to its ``launches``
count. It never falls back from the kernel to the plain version.

Layouts follow the JAX package, with a leading batch dimension: ``qkv`` is
``(B, n, 3D)`` with columns in ``'n (qkv h d)'`` order, ``g_qkv`` and
``cam_qkv`` come back in that layout, and the rollout takes pre-reduced
``(B, L, n, n)`` maps or per-head ``(B, L, h, n, n)`` ones.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from transformer_explainability_torch.ops import relprop as rp
from transformer_explainability_torch.ops.bert_math import (
    BertLayerParams, bert_attn_rev_core_plain, bert_layer_fwd_core_plain,
    bert_out_rev_core_plain)
from transformer_explainability_torch.ops.block_math import (
    BlockParams, attn_rev_math, block_fwd_core_plain, block_rev_core_plain,
    merge_heads, mlp_rev_math, split_heads)
from transformer_explainability_torch.ops.precision import (
    PreparedWeight, kabs, kdot, transpose)
from transformer_explainability_torch.ops.tp_math import (
    mlp_rev_tp_phase1_plain, mlp_rev_tp_phase2_plain)

Tensor = torch.Tensor

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
MAX_HEAD_DIM = 64        # the attention tiles hold 64 head columns


# ---------------------------------------------------------------------------
# Plain versions (JAX: the attention kernels' bodies with their product
# modes, whose float32 mode is _attn_fwd_core_jnp / _attn_rev_core_jnp, and
# the jnp branch of rollout_from_grad_cam)
# ---------------------------------------------------------------------------

def attn_fwd_core_plain(qkv: Tensor, num_heads: int, head_dim: int,
                        scale: float, mxu: str = "float32") -> Tensor:
    """JAX ``_attn_fwd_kernel``: both products in ``mxu``."""
    q, k, v = split_heads(qkv, num_heads, head_dim)
    attn = torch.softmax(kdot(q, k.transpose(-1, -2), mxu) * scale, dim=-1)
    return merge_heads(kdot(attn, v, mxu))


def attn_rev_core_plain(qkv: Tensor, g_o: Tensor, cam_o: Tensor,
                        num_heads: int, head_dim: int, scale: float,
                        attn_mxu: str = "float32", rule_mxu: str = "float32"
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """JAX ``_attn_rev_kernel``: the recompute and gradient products in
    ``attn_mxu``, the z-rule products in ``rule_mxu``."""
    return attn_rev_math(qkv, g_o, cam_o, num_heads, head_dim, scale,
                         attn_mxu, rule_mxu)


def head_mean_grad_cam(cams: Tensor, grads: Optional[Tensor] = None
                       ) -> Tensor:
    """Per-head ``(B, L, h, n, n)`` maps -> ``mean_h (grads ⊙ cams)⁺``
    ``(B, L, n, n)`` (``grads=None``: ``mean_h cams⁺``): the elementwise prep
    JAX's ``rollout_from_grad_cam`` runs in XLA before its chain kernel, and
    the plain version of the rollout kernel's head-mean pass."""
    m = cams if grads is None else grads * cams
    return m.clamp(min=0).mean(dim=2)


def rollout_plain(cams: Tensor, start_layer: int = 0,
                  row_normalize: bool = False,
                  grads: Optional[Tensor] = None,
                  rows: Optional[int] = None) -> Tensor:
    """The chain by its definition (``relprop.compute_rollout``), then its
    leading ``rows`` rows (``None``: all)."""
    if cams.ndim == 5:
        cams = head_mean_grad_cam(cams, grads)
    joint = rp.compute_rollout(cams, start_layer, row_normalize)
    return joint if rows is None else joint[..., :rows, :]


def mlp_rev_core_plain(x_mid: Tensor, g_out: Tensor, R: Tensor,
                       p: BlockParams, eps: float, mxu: str = "bfloat16",
                       rule_mxu: str = "bfloat16") -> Tuple[Tensor, Tensor]:
    """JAX ``_mlp_rev_math`` (the one-shot body of ``_mlp_rev_kernel``):
    the recompute and backward products in ``mxu``, the rule products in
    ``rule_mxu``; returns ``(g_mid, Rm)``."""
    return mlp_rev_math(x_mid, g_out, R, p, eps=eps, mxu=mxu,
                        rule_mxu=rule_mxu)


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


# the wrappers' launch counts: two threads launch on a server (the fast
# program and the verifier tier), so each count moves under a lock
_COUNT_LOCK = threading.Lock()


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


def _launch_attn_fwd(lib, qkv: Tensor, num_heads: int, head_dim: int,
                     scale: float, stream, attn_mode: int = 0) -> Tensor:
    b, n, _ = qkv.shape
    out = torch.empty(b, n, num_heads * head_dim, dtype=qkv.dtype,
                      device=qkv.device)
    fn = getattr(lib, f"te_attn_fwd_{_DTYPES[qkv.dtype]}")
    _raise_on_error("attn_fwd_core", lib, fn(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, head_dim,
        float(scale), attn_mode, stream))
    return out


def _launch_attn_rev(lib, qkv: Tensor, g_o: Tensor, cam_o: Tensor,
                     num_heads: int, head_dim: int, scale: float, stream,
                     attn_mode: int = 0, rule_mode: int = 0):
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
        head_dim, float(scale), attn_mode, rule_mode, stream))
    return g_qkv, cam_qkv, gc


def _launch_rollout(lib, cams: Tensor, start_layer: int, row_normalize: bool,
                    stream, grads: Optional[Tensor] = None,
                    rows: Optional[int] = None) -> Tensor:
    """One chain launch over pre-reduced ``(B, L, n, n)`` maps; per-head
    ``(B, L, h, n, n)`` ones (with optional ``grads``) take the head-mean
    pass first, into a ``(B, L - start, n, n)`` workspace."""
    b, L, n = cams.shape[0], cams.shape[1], cams.shape[-1]
    h = cams.shape[2] if cams.ndim == 5 else 0
    rows = n if rows is None else rows
    kw = dict(dtype=cams.dtype, device=cams.device)
    out = torch.empty(b, rows, n, **kw)
    work = torch.empty(b, max(L - start_layer, 0), n, n, **kw) if h else None
    fn = getattr(lib, f"te_rollout_{_DTYPES[cams.dtype]}")
    _raise_on_error("rollout_from_grad_cam", lib, fn(
        cams.data_ptr(), None if grads is None else grads.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(), b, L, h,
        n, start_layer, int(row_normalize), rows, stream))
    return out


# product modes of the kernels' C entry points: the GEMM core's (the block
# and layer kernels' weight products) and the attention kernels' (B2-B5's
# attention and attention-rule products; B7 and B9 take the first two)
_GEMM_MODE = {"bfloat16": 0, "tensorfloat32": 1}
_ATTN_MODE = {"float32": 0, "bfloat16": 1, "tensorfloat32": 2}
_BERT = "ROADMAP B, raw tensorfloat32 (BERT)"


def _mode_flag(name: str, key: str, mode: str, table: dict) -> int:
    if mode not in table:
        raise NotImplementedError(
            f"{name}: {key} mode {mode!r} has no kernel instantiation "
            f"(ROADMAP B, raw tensorfloat32)")
    return table[mode]


# BlockParams and BertLayerParams share one layout: eight vectors (two
# LayerNorms' scales and biases, the qkv, attention-output, first and second
# MLP biases), then the four prepared weights; the helpers below read them
# by position, as the C entry points' BlockWeights does.

def _block_modes(name: str, p, **modes) -> dict:
    """Map the product modes to the kernels' flags (``*_mode``: the
    attention kernels', else the GEMM core's); raise on a mode or a weight
    preparation the kernel does not take. A bf16×3 attention product takes
    no weight; a bf16×3 GEMM product needs the (hi, lo) pairs."""
    out = {}
    for key, mode in modes.items():
        table = _ATTN_MODE if key.endswith("_mode") else _GEMM_MODE
        out[key] = _mode_flag(name, key, mode, table)
    if p[0].shape[0] % 8 or p[6].shape[0] % 8:
        raise ValueError(f"{name}: the kernel needs the embedding and MLP "
                         "widths to be multiples of 8")
    paired = all(len(w) == 2 for w in p[8:])
    if any(out.get(k) == 1 for k in ("mxu", "mlp", "rule")) and not paired:
        raise ValueError(f"{name}: a tensorfloat32 product needs weights "
                         "prepared as (hi, lo) pairs")
    return out


def _bert_modes(name: str, p, **modes) -> dict:
    """:func:`_block_modes` for the BERT layer kernels, which have no
    bf16×3 attention or rule instance yet: a ``tensorfloat32`` attention or
    rule mode raises naming its ROADMAP item before any flag is formed."""
    for key in ("attn_mode", "rule_mode", "rule"):
        if modes.get(key) == "tensorfloat32":
            raise NotImplementedError(
                f"{name}: tensorfloat32 {key.replace('_mode', '')} products "
                f"have no BERT kernel instantiation yet ({_BERT})")
    return _block_modes(name, p, **modes)


def _check_block_params(name: str, p, like: Tensor, D: int, M: int) -> None:
    _check(name, [like, *p[:8]], [like.shape] + [(D,)] * 4
           + [(3 * D,), (D,), (M,), (D,)])
    for w, shape in zip(p[8:], ((3 * D, D), (D, D), (M, D), (D, M))):
        for t in w:
            if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                    or not t.is_contiguous() or t.device != like.device):
                raise ValueError(f"{name}: prepared weights must be "
                                 f"contiguous bf16 {shape} on {like.device}")


def _weight_ptrs(p):
    ptrs = []
    for w in p[8:]:
        ptrs += _planes(w)
    return ptrs


def _abs_ptrs(name: str, p):
    """The |W| planes of the four prepared weights, as ``_weight_ptrs``."""
    ptrs = []
    for w in p[8:]:
        ptrs += _abs_planes(name, w)
    return ptrs


def _vec_ptrs(p):
    return [t.data_ptr() for t in p[:8]]


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
            flags["attn_mode"], flags["mlp"]]
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
            flags["attn_mode"], flags["rule_mode"], flags["rule"],
            flags["mlp"]]
    work = _workspace(fn, dims, x_in.device)
    _raise_on_error("block_rev_core", lib, fn(
        *[t.data_ptr() for t in (x_in, x_mid, out_m, g_out, R, *saved)],
        *_vec_ptrs(p), *_weight_ptrs(p), *_abs_ptrs("block_rev_core", p),
        g_in.data_ptr(), R_in.data_ptr(), gc.data_ptr(), work.data_ptr(),
        None, *dims, stream))
    return g_in, R_in, gc


def _bert_mask(name: str, mask: Tensor, like: Tensor) -> None:
    b, S = like.shape[:2]
    _check(name, [like, mask], [like.shape, (b, S)])


def _launch_bert_fwd(lib, x: Tensor, mask: Tensor, p: BertLayerParams,
                     num_heads: int, head_dim: int, eps: float, flags: dict,
                     stream):
    b, S, D = x.shape
    kw = dict(dtype=x.dtype, device=x.device)
    outs = (torch.empty(b, S, D, **kw), torch.empty(b, S, D, **kw),
            torch.empty(b, S, 3 * D, **kw), torch.empty(b, S, D, **kw),
            torch.empty(b, S, D, **kw))
    fn = lib.te_bert_fwd_f32
    dims = [b, S, num_heads, head_dim, p.b_i.shape[0], float(eps),
            flags["mxu"], flags["attn_mode"], flags["mlp"]]
    work = _workspace(fn, dims, x.device)
    _raise_on_error("bert_layer_fwd_core", lib, fn(
        x.data_ptr(), mask.data_ptr(), *_vec_ptrs(p), *_weight_ptrs(p),
        *[o.data_ptr() for o in outs], work.data_ptr(), None, *dims, stream))
    return outs


def _launch_bert_out_rev(lib, att_ln: Tensor, g_out: Tensor, R: Tensor,
                         p: BertLayerParams, eps: float, flags: dict, stream):
    b, S, D = att_ln.shape
    g_attln, R_att = torch.empty_like(att_ln), torch.empty_like(att_ln)
    fn = lib.te_bert_out_rev_f32
    dims = [b, S, D, p.b_i.shape[0], float(eps), flags["mlp"], flags["rule"]]
    work = _workspace(fn, dims, att_ln.device)
    _raise_on_error("bert_out_rev_core", lib, fn(
        att_ln.data_ptr(), g_out.data_ptr(), R.data_ptr(), *_vec_ptrs(p),
        *_weight_ptrs(p), *_abs_ptrs("bert_out_rev_core", p),
        g_attln.data_ptr(), R_att.data_ptr(), work.data_ptr(), None, *dims,
        stream))
    return g_attln, R_att


def _launch_bert_attn_rev(lib, x_in: Tensor, g_attln: Tensor, R_att: Tensor,
                          mask: Tensor, saved, p: BertLayerParams,
                          num_heads: int, head_dim: int, eps: float,
                          flags: dict, stream):
    b, S, D = x_in.shape
    g_in, R_in = torch.empty_like(x_in), torch.empty_like(x_in)
    gc = torch.empty(b, S, S, dtype=x_in.dtype, device=x_in.device)
    fn = lib.te_bert_attn_rev_f32
    dims = [b, S, num_heads, head_dim, float(eps), flags["mxu"],
            flags["attn_mode"], flags["rule_mode"], flags["rule"]]
    work = _workspace(fn, dims, x_in.device)
    _raise_on_error("bert_attn_rev_core", lib, fn(
        *[t.data_ptr() for t in (x_in, g_attln, R_att, mask, *saved)],
        *_vec_ptrs(p), *_weight_ptrs(p), *_abs_ptrs("bert_attn_rev_core", p),
        g_in.data_ptr(), R_in.data_ptr(), gc.data_ptr(), work.data_ptr(),
        None, *dims, stream))
    return g_in, R_in, gc


def _planes(w):
    """A prepared weight's (hi, lo) pointers (lo null for a one-pass
    split)."""
    return [w[0].data_ptr(), w[1].data_ptr() if len(w) > 1 else None]


def _abs_planes(name: str, w):
    """The (hi, lo) pointers of a prepared weight's |W| planes
    (:class:`..precision.PreparedWeight`), which the rule products read."""
    if not isinstance(w, PreparedWeight):
        raise ValueError(f"{name}: the kernel takes weights prepared by "
                         "precision.prepare_weight (with their |W| planes)")
    return _planes(w.abs)


def _launch_mlp_rev_tp1(lib, x_mid: Tensor, g_out: Tensor, ln2s: Tensor,
                        ln2b: Tensor, b1: Tensor, w1, w2, eps: float,
                        flags: dict, stream, fused: bool = True):
    b, n, D = x_mid.shape
    Ml = b1.shape[0]
    fc1_pre = torch.empty(b, n, Ml, dtype=x_mid.dtype, device=x_mid.device)
    parts = [torch.empty_like(x_mid) for _ in range(3)]
    fn = lib.te_mlp_rev_tp1_f32
    dims = [b * n, D, Ml, float(eps), flags["mlp"], flags["rule"], int(fused)]
    work = _workspace(fn, dims, x_mid.device)
    _raise_on_error("mlp_rev_tp_phase1", lib, fn(
        *[t.data_ptr() for t in (x_mid, g_out, ln2s, ln2b, b1)],
        *_planes(w1), *_planes(w2), *_abs_planes("mlp_rev_tp_phase1", w2),
        fc1_pre.data_ptr(),
        *[t.data_ptr() for t in parts], work.data_ptr(), None, *dims,
        stream))
    return (fc1_pre, *parts)


def _launch_mlp_rev_tp2(lib, x_mid: Tensor, Sr: Tensor, fc1_pre: Tensor,
                        ln2s: Tensor, ln2b: Tensor, b1: Tensor, w1, w2,
                        eps: float, flags: dict, stream, fused: bool = True):
    b, n, D = x_mid.shape
    num_w, num_a = torch.empty_like(x_mid), torch.empty_like(x_mid)
    fn = lib.te_mlp_rev_tp2_f32
    dims = [b * n, D, b1.shape[0], float(eps), flags["rule"], int(fused)]
    work = _workspace(fn, dims, x_mid.device)
    _raise_on_error("mlp_rev_tp_phase2", lib, fn(
        *[t.data_ptr() for t in (x_mid, Sr, fc1_pre, ln2s, ln2b, b1)],
        *_planes(w1), *_planes(w2), *_abs_planes("mlp_rev_tp_phase2", w1),
        *_abs_planes("mlp_rev_tp_phase2", w2), num_w.data_ptr(),
        num_a.data_ptr(), work.data_ptr(), None, *dims, stream))
    return num_w, num_a


def _launch_mlp_rev(lib, x_mid: Tensor, g_out: Tensor, R: Tensor,
                    p: BlockParams, eps: float, flags: dict, stream):
    b, n, D = x_mid.shape
    g_mid, Rm = torch.empty_like(x_mid), torch.empty_like(x_mid)
    fn = lib.te_mlp_rev_f32
    dims = [b, n, D, p.b1.shape[0], float(eps), flags["mlp"], flags["rule"]]
    work = _workspace(fn, dims, x_mid.device)
    _raise_on_error("mlp_rev_core", lib, fn(
        *[t.data_ptr() for t in (x_mid, g_out, R, p.ln2s, p.ln2b, p.b1, p.b2)],
        *_planes(p.w1), *_planes(p.w2), *_abs_planes("mlp_rev_core", p.w1),
        *_abs_planes("mlp_rev_core", p.w2), g_mid.data_ptr(), Rm.data_ptr(),
        work.data_ptr(), None, *dims, stream))
    return g_mid, Rm


def _launch_gemm(lib, a: Tensor, w, flag: int, wt: bool, absolute: bool,
                 dual: bool, tile: int, stream):
    """The core alone; ``a`` float32, or bf16 rows (one-pass products
    ``g·W``, plain or dual, on the core's bf16 A path)."""
    M, K = a.shape
    N = w[0].shape[0] if wt else w[0].shape[1]
    C = torch.empty(M, N, dtype=torch.float32, device=a.device)
    C_abs = torch.empty_like(C) if dual else None
    _raise_on_error("gemm_core", lib, lib.te_gemm_f32(
        a.data_ptr(), *_planes(w.abs if absolute else w),
        *_abs_planes("gemm_core", w), C.data_ptr(),
        None if C_abs is None else C_abs.data_ptr(), M, N, K, K,
        w[0].shape[1], flag, int(wt), int(absolute), int(dual), tile,
        int(a.dtype == torch.bfloat16), stream))
    return (C, C_abs) if dual else C


# the core's fused passes (csrc/gemm.cu, te_gemm_fused_f32), by kind: bf16
# rows a0, a1 and prepared weights w0, w1 (:func:`gemm_core_fused_plain`)
FUSED_KINDS = {"two_a": 0, "dual_abs_a": 1, "three": 2, "group": 3}


def _launch_gemm_fused(lib, kind: str, flag: int, a0: Tensor, w0,
                       a1: Optional[Tensor], w1, stream):
    """One fused pass of the core alone (or its grouped launch); see
    :func:`gemm_core_fused_plain` for what each kind computes."""
    M, K = a0.shape
    wt0 = kind != "three"
    N = w0[0].shape[0] if wt0 else w0[0].shape[1]
    n_out = 2 if kind in ("two_a", "dual_abs_a") else 3
    outs = [torch.empty(M, N, dtype=torch.float32, device=a0.device)
            for _ in range(n_out)]
    # the planes p0, p1, p2 of te_gemm_fused_f32, each's pitch its width
    planes = (w0[0], (w1 if kind == "two_a" else w0.abs)[0],
              None if n_out == 2 else (w1.abs if kind == "three" else w1)[0])
    lds = [0 if t is None else t.shape[1] for t in planes]
    ptr = lambda t: None if t is None else t.data_ptr()
    _raise_on_error("gemm_core", lib, lib.te_gemm_fused_f32(
        FUSED_KINDS[kind], flag, a0.data_ptr(), ptr(a1),
        *[ptr(t) for t in planes], *[o.data_ptr() for o in outs],
        *([None] * (3 - n_out)), M, N, K, K, K if a1 is not None else 0,
        *lds, stream))
    return tuple(outs)


def _check_tp_weights(name: str, weights, like: Tensor, Ml: int) -> None:
    """This shard's ``w1_l (M/k, D)`` and ``w2_l (D, M/k)``: tensors or
    prepared splits, contiguous, on ``like``'s device."""
    D = like.shape[-1]
    for w, shape in zip(weights, ((Ml, D), (D, Ml))):
        for t in (w if isinstance(w, tuple) else (w,)):
            if (tuple(t.shape) != shape or not t.is_contiguous()
                    or t.device != like.device):
                raise ValueError(f"{name}: weights must be contiguous "
                                 f"{shape} on {like.device}")


def _tp_modes(name: str, x: Tensor, weights, **modes) -> dict:
    """The MLP kernels' GEMM flags (the TP phases and ``mlp_rev_core``);
    raise on what the kernel does not take."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32")
    out = {}
    for key, mode in modes.items():
        if mode == "float32":
            raise NotImplementedError(
                f"{name}: float32 {key} products have no kernel: the JAX "
                "form is the TPU's bf16x6 emulation, which the port does not "
                "carry (ROADMAP B, not to port); the float32 base takes the "
                "plain MLP arm")
        out[key] = _mode_flag(name, key, mode, _GEMM_MODE)
    for w in weights:
        if not isinstance(w, tuple) or any(t.dtype != torch.bfloat16
                                           for t in w):
            raise ValueError(f"{name}: the kernel takes weights prepared as "
                             "bf16 splits (precision.prepare_weight)")
        if 1 in out.values() and len(w) != 2:
            raise ValueError(f"{name}: a tensorfloat32 product needs weights "
                             "prepared as (hi, lo) pairs")
    if x.shape[-1] % 8 or weights[0][0].shape[0] % 8:
        raise ValueError(f"{name}: the kernel needs the embedding and "
                         "(shard) MLP widths to be multiples of 8")
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def attn_fwd_core(qkv: Tensor, num_heads: int, head_dim: int,
                  scale: float, mxu: str = "float32") -> Tensor:
    """Softmax attention from raw ``qkv (B, n, 3D)`` -> merged ``(B, n, D)``
    (JAX ``pallas_kernels.attn_fwd_core``), both products in ``mxu``
    (``"float32"``, ``"bfloat16"`` or ``"tensorfloat32"``, the bf16×3
    split)."""
    D = num_heads * head_dim
    b, n = qkv.shape[:2] if qkv.ndim == 3 else (-1, -1)
    device = _check("attn_fwd_core", [qkv], [(b, n, 3 * D)])
    if device == "cpu":
        return attn_fwd_core_plain(qkv, num_heads, head_dim, scale, mxu)
    flag = _mode_flag("attn_fwd_core", "mxu", mxu, _ATTN_MODE)
    with torch.cuda.device(qkv.device):
        out = _launch_attn_fwd(_lib(), qkv, num_heads, head_dim, scale,
                               _stream(qkv), flag)
    _count(attn_fwd_core)
    return out


def attn_rev_core(qkv: Tensor, g_o: Tensor, cam_o: Tensor, num_heads: int,
                  head_dim: int, scale: float, attn_mxu: str = "float32",
                  rule_mxu: str = "float32") -> Tuple[Tensor, Tensor, Tensor]:
    """Fused backward + LRP relprop of the attention core (JAX
    ``pallas_kernels.attn_rev_core``). ``qkv (B, n, 3D)``; ``g_o``,
    ``cam_o (B, n, D)`` are the merged-head gradient and relevance at the
    AV output. Returns ``(g_qkv (B, n, 3D), cam_qkv (B, n, 3D),
    gc (B, n, n))``: the qkv-layout cotangent and relevance, and the
    head-mean ``(grad ⊙ cam)⁺`` map. The recompute and gradient products
    run in ``attn_mxu``, the z-rule products in ``rule_mxu`` (each
    ``"float32"``, ``"bfloat16"`` or ``"tensorfloat32"``: every pair has
    an instance)."""
    D = num_heads * head_dim
    b, n = qkv.shape[:2] if qkv.ndim == 3 else (-1, -1)
    device = _check("attn_rev_core", [qkv, g_o, cam_o],
                    [(b, n, 3 * D), (b, n, D), (b, n, D)])
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"attn_rev_core: head_dim {head_dim} > "
                         f"{MAX_HEAD_DIM} is not supported by the kernel")
    if device == "cpu":
        return attn_rev_core_plain(qkv, g_o, cam_o, num_heads, head_dim,
                                   scale, attn_mxu, rule_mxu)
    flags = (_mode_flag("attn_rev_core", "attn", attn_mxu, _ATTN_MODE),
             _mode_flag("attn_rev_core", "rule", rule_mxu, _ATTN_MODE))
    with torch.cuda.device(qkv.device):
        outs = _launch_attn_rev(_lib(), qkv, g_o, cam_o, num_heads, head_dim,
                                scale, _stream(qkv), *flags)
    _count(attn_rev_core)
    return outs


def rollout_from_grad_cam(cams: Tensor, start_layer: int = 0,
                          row_normalize: bool = False,
                          grads: Optional[Tensor] = None,
                          rows: Optional[int] = None) -> Tensor:
    """Rollout chain ``Π_{i=L-1..start} (I + cams_i)`` (JAX
    ``pallas_kernels.rollout_from_grad_cam``) over pre-reduced
    ``(B, L, n, n)`` maps, or over per-head ``(B, L, h, n, n)`` ones with
    optional ``grads`` of their shape, head-meaned first as
    :func:`head_mean_grad_cam`. Returns ``(B, rows, n)``: the product's
    leading ``rows`` rows, all ``n`` when ``rows`` is ``None`` (what the JAX
    function returns). On the card it is one chain launch (per-head maps add
    the head-mean pass before it); ``rows=1`` launches only the row blocks
    that hold row 0. The launch refuses an ``n`` whose rows one block's
    shared memory cannot hold (about 4,400 tokens for ``rows=1`` in float32,
    2,000 for the full form)."""
    if (cams.ndim not in (4, 5) or cams.shape[-1] != cams.shape[-2]
            or (grads is not None and cams.ndim != 5)):
        raise ValueError(f"rollout_from_grad_cam: cams must be (B, L, n, n),"
                         f" or (B, L, h, n, n) with optional grads, got "
                         f"{tuple(cams.shape)}")
    n = cams.shape[-1]
    if rows is not None and not (isinstance(rows, int) and 1 <= rows <= n):
        raise ValueError(f"rollout_from_grad_cam: rows {rows!r} outside "
                         f"[1, {n}]")
    device = _check("rollout_from_grad_cam",
                    [cams] + ([] if grads is None else [grads]),
                    [cams.shape] * 2)
    if not 0 <= start_layer < cams.shape[1]:
        raise ValueError(f"rollout_from_grad_cam: start_layer {start_layer} "
                         f"outside [0, {cams.shape[1]})")
    if device == "cpu":
        return rollout_plain(cams, start_layer, row_normalize, grads, rows)
    with torch.cuda.device(cams.device):
        out = _launch_rollout(_lib(), cams, start_layer, row_normalize,
                              _stream(cams), grads, rows)
    _count(rollout_from_grad_cam)
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
                         attn_mode=attn_mxu)
    with torch.cuda.device(x.device):
        outs = _launch_block_fwd(_lib(), x, p, num_heads, head_dim, eps,
                                 flags, _stream(x))
    _count(block_fwd_core)
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
    ``saved`` form of :func:`block_fwd_core`, attention products in
    ``"float32"``, ``"bfloat16"`` or ``"tensorfloat32"`` and rule products
    in the latter two (a reduced base's rules are never float32)."""
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
    if rule_mxu == "float32":
        raise ValueError("block_rev_core: float32 rule products have no "
                         "block kernel (the weights are prepared as bf16 "
                         "splits)")
    flags = _block_modes("block_rev_core", p, mxu=mxu, mlp=mlp_mxu or mxu,
                         rule=rule_mxu, attn_mode=attn_mxu,
                         rule_mode=rule_mxu)
    with torch.cuda.device(x_in.device):
        outs = _launch_block_rev(_lib(), x_in, x_mid, out_m, g_out, R, saved,
                                 p, num_heads, head_dim, eps, flags,
                                 _stream(x_in))
    _count(block_rev_core)
    return outs


def _bert_kernel_checks(name: str, x: Tensor, head_dim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32")
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {head_dim} > {MAX_HEAD_DIM} is "
                         "not supported by the kernel")


def bert_layer_fwd_core(x: Tensor, mask: Tensor, p: BertLayerParams,
                        num_heads: int, head_dim: int, eps: float, mxu: str,
                        attn_mxu: str, mlp_mxu: Optional[str] = None,
                        save_attn: bool = False, save_probs: bool = False,
                        save_mlp: bool = False) -> Tuple[Tensor, ...]:
    """One whole post-norm BERT layer forward on ``x (B, S, D)`` with the
    ``(B, S)`` additive ``mask`` (JAX ``pallas_kernels.bert_layer_fwd_core``);
    returns ``(out, att_ln)`` and the anchors of
    :func:`.bert_math.bert_layer_fwd_core_plain`. The kernel computes the
    slim anchors in any case; the fat and MLP anchor forms run plain only."""
    D = num_heads * head_dim
    if x.ndim != 3 or x.shape[-1] != D:
        raise ValueError(f"bert_layer_fwd_core: x must be (B, S, {D}), got "
                         f"{tuple(x.shape)}")
    _bert_mask("bert_layer_fwd_core", mask, x)
    _check_block_params("bert_layer_fwd_core", p, x, D, p.b_i.shape[0])
    if x.device.type == "cpu":
        return bert_layer_fwd_core_plain(x, mask, p, num_heads, head_dim, eps,
                                         mxu, attn_mxu, mlp_mxu, save_attn,
                                         save_probs, save_mlp)
    _bert_kernel_checks("bert_layer_fwd_core", x, head_dim)
    if save_probs or save_mlp:
        raise NotImplementedError(
            "bert_layer_fwd_core: the kernel saves the slim anchors; the fat "
            "(probs) and MLP anchor forms are ROADMAP B (B7 anchor forms)")
    flags = _bert_modes("bert_layer_fwd_core", p, mxu=mxu,
                        mlp=mlp_mxu or mxu, attn_mode=attn_mxu)
    with torch.cuda.device(x.device):
        outs = _launch_bert_fwd(_lib(), x, mask, p, num_heads, head_dim, eps,
                                flags, _stream(x))
    _count(bert_layer_fwd_core)
    return outs[:5 if save_attn else 2]


def bert_out_rev_core(att_ln: Tensor, g_out: Tensor, R: Tensor,
                      p: BertLayerParams, eps: float, mxu: str, rule_mxu: str,
                      mlp_mxu: Optional[str] = None,
                      saved_mlp: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> Tuple[Tensor, Tensor]:
    """The reverse of a BERT layer's output sub-block (JAX
    ``pallas_kernels.bert_out_rev_core``): ``(g_attln, R_att)`` as
    :func:`.bert_math.bert_out_rev_core_plain`. The kernel recomputes the
    two MLP products (the MLP anchors are off by default)."""
    D = att_ln.shape[-1] if att_ln.ndim == 3 else -1
    I = p.b_i.shape[0]
    _check("bert_out_rev_core", [att_ln, g_out, R], [att_ln.shape] * 3)
    if att_ln.ndim != 3:
        raise ValueError("bert_out_rev_core: tensors must be (B, S, D)")
    _check_block_params("bert_out_rev_core", p, att_ln, D, I)
    if saved_mlp is not None:
        b, S = att_ln.shape[:2]
        _check("bert_out_rev_core", [att_ln, *saved_mlp],
               [att_ln.shape, (b, S, I), (b, S, D)])
    if att_ln.device.type == "cpu":
        return bert_out_rev_core_plain(att_ln, g_out, R, p, eps, mxu,
                                       rule_mxu, mlp_mxu, saved_mlp)
    _bert_kernel_checks("bert_out_rev_core", att_ln, 0)
    if saved_mlp is not None:
        raise NotImplementedError(
            "bert_out_rev_core: the kernel recomputes the MLP products; the "
            "saved-MLP form is ROADMAP B (B8 anchor form)")
    flags = _bert_modes("bert_out_rev_core", p, mlp=mlp_mxu or mxu,
                        rule=rule_mxu)
    with torch.cuda.device(att_ln.device):
        outs = _launch_bert_out_rev(_lib(), att_ln, g_out, R, p, eps, flags,
                                    _stream(att_ln))
    _count(bert_out_rev_core)
    return outs


def bert_attn_rev_core(x_in: Tensor, g_attln: Tensor, R_att: Tensor,
                       mask: Tensor, p: BertLayerParams, num_heads: int,
                       head_dim: int, eps: float, mxu: str, attn_mxu: str,
                       rule_mxu: str,
                       saved: Optional[Tuple[Tensor, ...]] = None
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The reverse of a BERT layer's masked attention sub-block (JAX
    ``pallas_kernels.bert_attn_rev_core``, variant ``ours``, α=1): returns
    ``(g_in, R_in, gc (B, S, S))`` as
    :func:`.bert_math.bert_attn_rev_core_plain`. The kernel takes the slim
    ``saved = (qkv_pre, ctx, dense_nb)`` of :func:`bert_layer_fwd_core`."""
    D = num_heads * head_dim
    b, S = x_in.shape[:2] if x_in.ndim == 3 else (-1, -1)
    _check("bert_attn_rev_core", [x_in, g_attln, R_att], [(b, S, D)] * 3)
    _bert_mask("bert_attn_rev_core", mask, x_in)
    _check_block_params("bert_attn_rev_core", p, x_in, D, p.b_i.shape[0])
    if saved is not None:
        if len(saved) not in (3, 5):
            raise ValueError("bert_attn_rev_core: saved holds 3 or 5 anchors")
        shapes = ([(b, S, 3 * D)] + [(b, num_heads * S, S)] * (len(saved) - 3)
                  + [(b, S, D)] * 2)
        _check("bert_attn_rev_core", [x_in, *saved], [x_in.shape] + shapes)
    if x_in.device.type == "cpu":
        return bert_attn_rev_core_plain(x_in, g_attln, R_att, mask, p,
                                        num_heads, head_dim, eps, mxu,
                                        attn_mxu, rule_mxu, saved)
    _bert_kernel_checks("bert_attn_rev_core", x_in, head_dim)
    if saved is None or len(saved) != 3:
        raise NotImplementedError(
            "bert_attn_rev_core: the kernel takes the slim saved anchors; the "
            "recompute and fat-anchor forms are ROADMAP B (B9 anchor forms)")
    flags = _bert_modes("bert_attn_rev_core", p, mxu=mxu, rule=rule_mxu,
                        attn_mode=attn_mxu, rule_mode=rule_mxu)
    with torch.cuda.device(x_in.device):
        outs = _launch_bert_attn_rev(_lib(), x_in, g_attln, R_att, mask,
                                     saved, p, num_heads, head_dim, eps,
                                     flags, _stream(x_in))
    _count(bert_attn_rev_core)
    return outs


def mlp_rev_tp_phase1(x_mid: Tensor, g_out: Tensor, ln2s: Tensor,
                      ln2b: Tensor, b1_l: Tensor, w1_l, w2_l, eps: float,
                      mxu: str = "bfloat16", rule_mxu: str = "bfloat16"
                      ) -> Tuple[Tensor, ...]:
    """Phase 1 of the tensor-parallel MLP reverse on this shard (JAX
    ``pallas_kernels.mlp_rev_tp_phase1``): ``x_mid``, ``g_out (B, n, D)``,
    the LN2 scale and bias, this shard's ``b1_l (M/k,)``, ``w1_l (M/k, D)``
    and ``w2_l (D, M/k)``. Returns ``(fc1_pre_l (B, n, M/k), fc2_pre_l,
    axw2_l, g_xn2_l (B, n, D))`` as :func:`.tp_math.mlp_rev_tp_phase1_plain`;
    the caller all-reduces the three partials. The kernel takes the
    weights as bf16 splits and products in ``"bfloat16"`` or
    ``"tensorfloat32"``."""
    name = "mlp_rev_tp_phase1"
    if x_mid.ndim != 3:
        raise ValueError(f"{name}: x_mid must be (B, n, D)")
    D, Ml = x_mid.shape[-1], b1_l.shape[0]
    device = _check(name, [x_mid, g_out, ln2s, ln2b, b1_l],
                    [x_mid.shape, x_mid.shape, (D,), (D,), (Ml,)])
    _check_tp_weights(name, (w1_l, w2_l), x_mid, Ml)
    if device == "cpu":
        return mlp_rev_tp_phase1_plain(x_mid, g_out, ln2s, ln2b, b1_l, w1_l,
                                       w2_l, eps, mxu, rule_mxu)
    flags = _tp_modes(name, x_mid, (w1_l, w2_l), mlp=mxu, rule=rule_mxu)
    with torch.cuda.device(x_mid.device):
        outs = _launch_mlp_rev_tp1(_lib(), x_mid, g_out, ln2s, ln2b, b1_l,
                                   w1_l, w2_l, eps, flags, _stream(x_mid))
    _count(mlp_rev_tp_phase1)
    return outs


def mlp_rev_tp_phase2(x_mid: Tensor, Sr: Tensor, fc1_pre_l: Tensor,
                      ln2s: Tensor, ln2b: Tensor, b1_l: Tensor, w1_l, w2_l,
                      eps: float, rule_mxu: str = "bfloat16"
                      ) -> Tuple[Tensor, Tensor]:
    """Phase 2 of the tensor-parallel MLP reverse on this shard (JAX
    ``pallas_kernels.mlp_rev_tp_phase2``): ``Sr (B, n, D)`` is the fc2
    rule's divide from the all-reduced phase-1 partials, ``fc1_pre_l``
    phase 1's anchor. Returns this shard's partials ``(num_w_l, num_a_l)``
    as :func:`.tp_math.mlp_rev_tp_phase2_plain`; every product is a rule
    product in ``rule_mxu``."""
    name = "mlp_rev_tp_phase2"
    if x_mid.ndim != 3:
        raise ValueError(f"{name}: x_mid must be (B, n, D)")
    D, Ml = x_mid.shape[-1], b1_l.shape[0]
    device = _check(name, [x_mid, Sr, fc1_pre_l, ln2s, ln2b, b1_l],
                    [x_mid.shape, x_mid.shape, (*x_mid.shape[:2], Ml), (D,),
                     (D,), (Ml,)])
    _check_tp_weights(name, (w1_l, w2_l), x_mid, Ml)
    if device == "cpu":
        return mlp_rev_tp_phase2_plain(x_mid, Sr, fc1_pre_l, ln2s, ln2b,
                                       b1_l, w1_l, w2_l, eps, rule_mxu)
    flags = _tp_modes(name, x_mid, (w1_l, w2_l), rule=rule_mxu)
    with torch.cuda.device(x_mid.device):
        outs = _launch_mlp_rev_tp2(_lib(), x_mid, Sr, fc1_pre_l, ln2s, ln2b,
                                   b1_l, w1_l, w2_l, eps, flags,
                                   _stream(x_mid))
    _count(mlp_rev_tp_phase2)
    return outs


def mlp_rev_core(x_mid: Tensor, g_out: Tensor, R: Tensor, p: BlockParams,
                 eps: float, mxu: str = "bfloat16",
                 rule_mxu: str = "bfloat16") -> Tuple[Tensor, Tensor]:
    """The MLP half of the ViT reverse step on the split path (JAX
    ``pallas_kernels.mlp_rev_core``, variant ``ours``, α=1): ``x_mid``,
    ``g_out``, ``R (B, n, D)`` and the block's parameters ``p``
    (:meth:`..models.vit.VisionTransformer.block_params`; only LN2, the MLP
    biases and ``w1``, ``w2`` are read). Returns ``(g_mid, Rm)`` as
    :func:`mlp_rev_core_plain`. The kernel takes the weights as bf16 splits
    and products in ``"bfloat16"`` or ``"tensorfloat32"``; float32 runs
    plain only."""
    name = "mlp_rev_core"
    if x_mid.ndim != 3:
        raise ValueError(f"{name}: x_mid must be (B, n, D)")
    D, M = x_mid.shape[-1], p.b1.shape[0]
    device = _check(name, [x_mid, g_out, R, p.ln2s, p.ln2b, p.b1, p.b2],
                    [x_mid.shape] * 3 + [(D,), (D,), (M,), (D,)])
    _check_tp_weights(name, (p.w1, p.w2), x_mid, M)
    if device == "cpu":
        return mlp_rev_core_plain(x_mid, g_out, R, p, eps, mxu, rule_mxu)
    flags = _tp_modes(name, x_mid, (p.w1, p.w2), mlp=mxu, rule=rule_mxu)
    with torch.cuda.device(x_mid.device):
        outs = _launch_mlp_rev(_lib(), x_mid, g_out, R, p, eps, flags,
                               _stream(x_mid))
    _count(mlp_rev_core)
    return outs


def gemm_core_plain(a: Tensor, w, mxu: str, wt: bool = True,
                    absolute: bool = False, dual: bool = False):
    """What the GEMM core computes (``csrc/gemm.cuh``; JAX ``_kdot`` of an
    activation and a prepared weight): ``a (M, K)`` times ``wᵀ`` (``wt``,
    ``w`` an ``(N, K)`` split) or ``w`` (``(K, N)``) in product mode
    ``mxu``; ``absolute``: ``|a|`` times the same of ``|w|``; ``dual``:
    ``(a·w, a·|w|)``. ``w`` is a :class:`..precision.PreparedWeight`."""
    def op(planes):
        return transpose(planes) if wt else planes

    if absolute:
        return kdot(a.abs(), op(kabs(w)), mxu)
    out = kdot(a, op(tuple(w)), mxu)
    return (out, kdot(a, op(kabs(w)), mxu)) if dual else out


def gemm_core(a: Tensor, w, mxu: str, wt: bool = True,
              absolute: bool = False, dual: bool = False, tile: int = -1):
    """The GEMM core alone (``csrc/gemm.cu``, a store epilogue), as
    :func:`gemm_core_plain`: the entry that holds the core to its plain
    version at the layer kernels' shapes, in the instances they launch
    (``(wt, absolute, dual)`` = (1, 0, 0), (0, 0, 0), (1, 1, 0), (0, 0, 1))
    and both modes. ``a`` float32 on the card, or bf16 rows for the
    one-pass products ``g·W`` (plain or dual) that the tensor-parallel MLP
    kernels run on bf16 A; ``tile`` -1 takes the tile
    the layer kernels take for this shape, 0 the large, 1 the small one.
    Not on any path: its launches are counted apart from the kernels'."""
    name = "gemm_core"
    if a.ndim != 2 or not isinstance(w, PreparedWeight) or w[0].ndim != 2:
        raise ValueError(f"{name}: a (M, K) and a prepared weight")
    M, K = a.shape
    if (w[0].shape[1] if wt else w[0].shape[0]) != K:
        raise ValueError(f"{name}: weight {tuple(w[0].shape)} does not "
                         f"match a {tuple(a.shape)} (wt={wt})")
    if a.dtype == torch.bfloat16:       # bf16 rows: the core's gemm16
        if not a.is_contiguous():
            raise ValueError(f"{name}: input must be contiguous")
        if a.device.type == "cpu":
            return gemm_core_plain(a.float(), w, mxu, wt, absolute, dual)
        flag = _mode_flag(name, "mxu", mxu, _GEMM_MODE)
    else:
        if _check(name, [a], [(M, K)]) == "cpu":
            return gemm_core_plain(a, w, mxu, wt, absolute, dual)
        flag = _tp_modes(name, a, (w,), mxu=mxu)["mxu"]
    with torch.cuda.device(a.device):
        outs = _launch_gemm(_lib(), a, w, flag, wt, absolute, dual, tile,
                            _stream(a))
    _count(gemm_core)
    return outs


def gemm_core_fused_plain(kind: str, a0: Tensor, w0,
                          a1: Optional[Tensor] = None,
                          w1=None) -> Tuple[Tensor, ...]:
    """What the core's fused passes compute, all bf16 products
    (:func:`gemm_core_plain` each): ``two_a`` (a0·w0ᵀ, a1·w1),
    ``dual_abs_a`` (a0·w0ᵀ, |a0|·|w0|ᵀ), ``three`` (a0·w0, a0·|w0|,
    |a1|·|w1|ᵀ) and ``group`` (a0·w0ᵀ, |a0|·|w0|ᵀ, a1·w1), with ``w0``,
    ``w1`` :class:`..precision.PreparedWeight` s (N, K) where transposed,
    else (K, N)."""
    bf = "bfloat16"
    if kind == "two_a":
        return (gemm_core_plain(a0, w0, bf, True),
                gemm_core_plain(a1, w1, bf, False))
    if kind == "three":
        return (*gemm_core_plain(a0, w0, bf, False, dual=True),
                gemm_core_plain(a1, w1, bf, True, absolute=True))
    if kind not in ("dual_abs_a", "group"):
        raise ValueError(f"gemm_core_fused: unknown kind {kind!r}")
    dual_abs = (gemm_core_plain(a0, w0, bf, True),
                gemm_core_plain(a0, w0, bf, True, absolute=True))
    if kind == "group":
        return (*dual_abs, gemm_core_plain(a1, w1, bf, False))
    return dual_abs


def gemm_core_fused(kind: str, a0: Tensor, w0, a1: Optional[Tensor] = None,
                    w1=None, mxu: str = "bfloat16") -> Tuple[Tensor, ...]:
    """The GEMM core's fused passes alone (``csrc/gemm.cu``,
    ``te_gemm_fused_f32``), as :func:`gemm_core_fused_plain`: the two-operand
    pass, the dual pass whose second product takes |A|, the three-set pass
    and the grouped launch the tensor-parallel MLP kernels run. ``a0``,
    ``a1`` bf16 (M, K) rows (the operands those kernels stage as bf16). Not
    on any path: its launches are counted with :func:`gemm_core`'s."""
    name = "gemm_core"
    if kind not in FUSED_KINDS:
        raise ValueError(f"{name}: unknown fused kind {kind!r}")
    for t in (a0, a1):
        if t is not None and (not t.is_contiguous() or t.device != a0.device
                              or t.ndim != 2):
            raise ValueError(f"{name}: (M, K) contiguous rows on one device")
    if a0.device.type == "cpu":
        return gemm_core_fused_plain(kind, a0, w0, a1, w1)
    flag = _mode_flag(name, "mxu", mxu, _GEMM_MODE)
    with torch.cuda.device(a0.device):
        outs = _launch_gemm_fused(_lib(), kind, flag, a0, w0, a1, w1,
                                  _stream(a0))
    _count(gemm_core)
    return outs


attn_fwd_core.launches = 0
attn_rev_core.launches = 0
rollout_from_grad_cam.launches = 0
block_fwd_core.launches = 0
block_rev_core.launches = 0
bert_layer_fwd_core.launches = 0
bert_out_rev_core.launches = 0
bert_attn_rev_core.launches = 0
mlp_rev_tp_phase1.launches = 0
mlp_rev_tp_phase2.launches = 0
mlp_rev_core.launches = 0
gemm_core.launches = 0

WRAPPERS = (attn_fwd_core, attn_rev_core, rollout_from_grad_cam,
            block_fwd_core, block_rev_core, bert_layer_fwd_core,
            bert_out_rev_core, bert_attn_rev_core, mlp_rev_tp_phase1,
            mlp_rev_tp_phase2, mlp_rev_core)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for w in WRAPPERS:
            w.launches = 0


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return {w.__name__: w.launches for w in WRAPPERS}


class AttnOps(NamedTuple):
    """The kernel operations the ViT paths call (single-device and tensor
    parallel), so that a reference run can take the plain versions
    explicitly on any device."""
    attn_fwd_core: Callable
    attn_rev_core: Callable
    rollout_from_grad_cam: Callable
    block_fwd_core: Callable
    block_rev_core: Callable
    mlp_rev_tp_phase1: Callable
    mlp_rev_tp_phase2: Callable
    mlp_rev_core: Callable


KERNEL_OPS = AttnOps(attn_fwd_core, attn_rev_core, rollout_from_grad_cam,
                     block_fwd_core, block_rev_core, mlp_rev_tp_phase1,
                     mlp_rev_tp_phase2, mlp_rev_core)
PLAIN_OPS = AttnOps(attn_fwd_core_plain, attn_rev_core_plain, rollout_plain,
                    block_fwd_core_plain, block_rev_core_plain,
                    mlp_rev_tp_phase1_plain, mlp_rev_tp_phase2_plain,
                    mlp_rev_core_plain)


class BertOps(NamedTuple):
    """The kernel operations the BERT path calls (the same role as
    :class:`AttnOps`)."""
    bert_layer_fwd_core: Callable
    bert_out_rev_core: Callable
    bert_attn_rev_core: Callable
    rollout_from_grad_cam: Callable


BERT_KERNEL_OPS = BertOps(bert_layer_fwd_core, bert_out_rev_core,
                          bert_attn_rev_core, rollout_from_grad_cam)
BERT_PLAIN_OPS = BertOps(bert_layer_fwd_core_plain, bert_out_rev_core_plain,
                         bert_attn_rev_core_plain, rollout_plain)
