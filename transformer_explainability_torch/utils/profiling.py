"""Profiling and timing helpers.

Port of ``transformer_explainability_tpu/utils/profiling.py``: ``sync``
waits for the card (``torch.cuda.synchronize``), ``trace`` records a
``torch.profiler`` trace of a block (a Chrome trace, viewable in Perfetto),
``timeit`` gives the mean seconds of a call after warm-up. JAX's relay guard
(``TraceRefusedError``) belongs to its TPU backend and has no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree=None) -> None:
    """Block until the card has finished the work queued so far (a no-op
    when ``tree`` holds no CUDA tensor, or with no card and no ``tree``)."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    for t in _tensors(tree):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


@contextlib.contextmanager
def trace(logdir: str = "build/profiles", name: str = "trace"):
    """Record the block under ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write ``{logdir}/{name}.json`` (Chrome trace)::

        with profiling.trace("build/profiles") as prof:
            fn(args)
        prof.key_averages()
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(logdir, name + ".json"))


def timeit(fn: Callable, *args, iters: int = 8, warmup: int = 1,
           name: Optional[str] = None, quiet: bool = False) -> float:
    """Mean seconds per call over ``iters`` calls after ``warmup`` (host
    clock around :func:`sync`; the first calls build the kernels)."""
    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        sync(fn(*args))
    dt = (time.perf_counter() - t0) / iters
    if not quiet:
        print(f"{name or getattr(fn, '__name__', 'fn')}: {dt * 1e3:.2f} ms")
    return dt
