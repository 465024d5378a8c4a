"""Each product of a JAX explain program as its lowered program states it,
and each product of a port call as it runs, as comparable (key, mode) pairs.

JAX on the CPU ignores the matmul precision when it computes, but the
program it lowers keeps it: every ``stablehlo.dot_general`` carries
``precision = [DEFAULT|HIGH|HIGHEST, ...]``, from an explicit
``precision=`` or the ambient ``jax.default_matmul_precision`` (nested
contexts show through). On its TPU these are one bf16 pass, bf16×3 and
exact float32; in the port the product modes ``"bfloat16"``,
``"tensorfloat32"`` and ``"float32"`` (:data:`JAX_MODE`).

A product's key is ``(batch, contracted, (m, n))``: the product of the
batch dimensions' sizes, of the contracted ones', and the sorted pair of
the two operands' free sizes. JAX explains one sample; the port's calls
here run one sample too, so its leading batch of 1 drops out. The sorted
pair makes a product and its transposed form (``a·b`` against ``bᵀ·aᵀ``,
as JAX's transpose rules may lower a gradient) one key.
"""

import contextlib
import math
import re

import jax
import torch

from transformer_explainability_torch.ops import precision as prec

JAX_MODE = {"DEFAULT": "bfloat16", "HIGH": "tensorfloat32",
            "HIGHEST": "float32"}

_TENSOR = re.compile(r"tensor<([^>]*)>")
_DIMS = r"\[([\d, ]*)\] x \[([\d, ]*)\]"


def _ints(s):
    return [int(t) for t in s.split(",") if t.strip()]


def _shape(t):
    return [int(d) for d in t.split("x")[:-1]]


def _key(batch, contracted, m, n):
    return (batch, contracted, tuple(sorted((m, n))))


def jax_products(fn, *args):
    """The (key, mode) pairs of every ``dot_general`` in the StableHLO of
    ``jax.jit(fn)`` lowered at ``args``."""
    text = jax.jit(fn).lower(*args).as_text()
    out = set()
    for line in text.splitlines():
        if "stablehlo.dot_general" not in line:
            continue
        lhs, rhs = (_shape(t) for t in _TENSOR.findall(
            line.split(" : ", 1)[1])[:2])
        bm = re.search(r"batching_dims = " + _DIMS, line)
        cm = re.search(r"contracting_dims = " + _DIMS, line)
        pm = re.search(r"precision = \[(\w+),", line)
        lb, rb = (_ints(bm.group(1)), _ints(bm.group(2))) if bm else ([], [])
        lc, rc = _ints(cm.group(1)), _ints(cm.group(2))
        size = lambda shp, idx: math.prod(shp[i] for i in idx)
        free = lambda shp, used: math.prod(
            d for i, d in enumerate(shp) if i not in used)
        key = _key(size(lhs, lb), size(lhs, lc), free(lhs, lb + lc),
                   free(rhs, rb + rc))
        out.add((key, JAX_MODE[pm.group(1) if pm else "DEFAULT"]))
    return out


@contextlib.contextmanager
def _hook(fn):
    old = prec.product_hook
    prec.product_hook = fn
    try:
        yield
    finally:
        prec.product_hook = old


@contextlib.contextmanager
def port_products():
    """Record the (key, mode) pair of every :func:`precision.product` run
    inside the block into the yielded set."""
    seen = set()

    def hook(a, b, mode):
        w = b[0] if isinstance(b, tuple) else b
        batch = math.prod(torch.broadcast_shapes(a.shape[:-2], w.shape[:-2]))
        seen.add((_key(batch, a.shape[-1], a.shape[-2], w.shape[-1]), mode))
        return mode

    with _hook(hook):
        yield seen


@contextlib.contextmanager
def rounding_off():
    """Every :func:`precision.product` inside the block runs exactly: the
    port's structure without its roundings, which JAX on the CPU computes
    for any precision."""
    with _hook(lambda a, b, mode: "float32"):
        yield


def assert_same_products(port, lowered):
    """The port's products and JAX's lowered program's are the same set of
    (key, mode) pairs: every product the port runs is one JAX lowers, in
    the same mode, and every product JAX lowers, in every mode exact
    float32 included, is one the port runs. On the CPU the port's kernel
    wrappers run their plain versions, whose products go through
    :func:`precision.product` too (B1's chain among them), so no product
    JAX lowers is out of the hook's sight."""
    extra = sorted(port - lowered)
    missing = sorted(lowered - port)
    assert not extra and not missing, (
        f"port products not in JAX's program: {extra}; JAX's products the "
        f"port does not run: {missing}")
