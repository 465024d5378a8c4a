"""The guarded mode's serving queue (JAX ``explain/serving.py``).

:class:`GuardedServer` runs the guarded ``production`` program
(:func:`..generator.make_guarded_explain_fn` with ``fallback="defer"``) on
the card and returns each batch's fast heatmaps at once, in a
:class:`BatchTicket`; a worker thread drains the flagged rows through a
verifier tier and splices its results into the ticket as they land:

  * ``tier="cpu"``: every flagged row runs the exact program on the host CPU
    (:func:`..generator.make_cpu_exact_fn`);
  * ``tier="gpu-f32"`` (JAX's ``"tpu-f32"``, the same semantics): flagged
    rows are re-checked in micro-batches by the exact-FP32 program on the
    card; a row whose production and FP32 heatmaps agree (corr >=
    ``tier_agreement``, default :data:`TIER_AGREEMENT`) is cleared with the
    FP32 heatmap, the others go on to the exact CPU program.

:meth:`GuardedServer.stats` reports the queue's sustained-load behaviour:
flag rate, queue wait, service time, queue depth and the verifier's busy
share.

Three faults of the JAX module are not carried over: its worker puts a row
of another model back on its own bounded queue (a full queue deadlocks, and
the row can starve), where this one keeps such rows in a local deque and
serves them next; its ticket counts its pending rows down without a lock,
where this one takes one; and the ``preprocess`` of its guarded function
reaches only the fast program, where here it reaches all three.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from transformer_explainability_torch.explain.generator import (
    ENVELOPE_BOUNDS, PRECISION_PRESETS, STRICT_AGREEMENT, _batch_corr,
    _guard_flags, _resolve_device, _to_host, make_cpu_exact_fn,
    make_explain_fn)
from transformer_explainability_torch.models.vit import (VIT_BASE_16_224,
                                                         ViTConfig)

# The escalation threshold of the gpu-f32 tier and of the strict
# deliver-f32 policy (JAX serving.TIER_AGREEMENT): a flagged row whose
# production and FP32 heatmaps correlate below it goes to the exact CPU
# program, above it the FP32 heatmap is delivered. It asks whether the FP32
# result can be trusted, not the production one (STRICT_AGREEMENT's
# question); JAX set it from 32 rows with f64 truth, measured on a TPU.
TIER_AGREEMENT = 0.99
TIERS = ("cpu", "gpu-f32")


class BatchTicket:
    """One submitted batch. ``heatmaps`` holds the fast results at once;
    each flagged row (``flagged``) that is queued is overwritten by its
    verifier's heatmap as it lands, also kept in ``corrections`` (row ->
    heatmap); a failed verification leaves the fast heatmap and records
    ``errors[row]``. ``delivered_f32`` marks the rows the strict
    ``deliver-f32`` policy replaced by the FP32 co-run's heatmap, ``shed``
    the flagged rows the escalation budget did not queue. :meth:`wait`
    blocks until every queued row is done."""

    def __init__(self, heatmaps: np.ndarray, flagged: np.ndarray,
                 score: np.ndarray,
                 delivered_f32: Optional[np.ndarray] = None,
                 shed: Optional[np.ndarray] = None):
        self.heatmaps = heatmaps
        self.flagged = flagged
        self.score = score
        self.delivered_f32 = delivered_f32
        self.shed = shed
        self.corrections: dict = {}
        self.errors: dict = {}
        self._lock = threading.Lock()
        self._pending = int(flagged.sum()) - (
            int(shed.sum()) if shed is not None else 0)
        self._done = threading.Event()
        if self._pending <= 0:
            self._done.set()

    def _deliver(self, row: int, heat: np.ndarray) -> None:
        self.heatmaps[row] = heat
        self.corrections[row] = heat
        self._finish_one()

    def _fail(self, row: int, err: BaseException) -> None:
        # a dead verifier must never hang wait() or drain()
        self.errors[row] = repr(err)
        self._finish_one()

    def _finish_one(self) -> None:
        with self._lock:
            self._pending -= 1
            done = self._pending <= 0
        if done:
            self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class GuardedServer:
    """Guarded serving of ViT ``transformer_attribution`` on ``device`` with
    an asynchronous verification queue (JAX ``serving.GuardedServer``).

    ``mode``, ``envelope_bounds``, ``agreement``, ``fallback_precision`` and
    ``precision_overrides`` (over the ``production`` preset) are those of
    :func:`..generator.make_guarded_explain_fn`, with deferred verification.
    ``max_queue`` bounds the queue (a full queue blocks the submitter);
    ``escalation_budget`` (None: no bound) caps the rows waiting for
    verification instead: flagged rows past it keep their delivered heatmap,
    are marked in ``ticket.shed`` and counted in ``stats()["n_shed"]``.
    ``tier`` is ``"cpu"`` or ``"gpu-f32"`` (envelope mode only: strict mode
    runs the FP32 program on every row already), with ``tier_agreement``
    and ``verify_batch`` rows a micro-batch (padded with its last row, so
    that a row's FP32 result does not depend on how many were coalesced).
    ``strict_policy="deliver-f32"`` (strict mode) replaces every flagged row
    by the FP32 co-run's heatmap at once and queues only the rows below
    ``tier_agreement``. ``input_format="uint8"`` takes raw ``(B, H, W, C)``
    uint8 frames, normalised on the device, in all three programs.

    :meth:`submit` serves one batch; :meth:`serve_stream` keeps ``depth``
    batches launched ahead of the oldest one's copy to the host. Use as a
    context manager or call :meth:`close`.
    """

    def __init__(self, cfg: ViTConfig = VIT_BASE_16_224, device="cuda",
                 start_layer: int = 0, mode: str = "envelope",
                 envelope_bounds: Optional[dict] = None,
                 agreement: Optional[float] = None,
                 fallback_precision: str = "float32",
                 max_queue: int = 256, escalation_budget: Optional[int] = None,
                 tier: str = "cpu", tier_agreement: Optional[float] = None,
                 verify_batch: int = 16, input_format: Optional[str] = None,
                 strict_policy: str = "cpu", **precision_overrides):
        if mode not in ("strict", "envelope"):
            raise ValueError(f"unknown guarded mode {mode!r}")
        if tier not in TIERS:
            raise ValueError(f"unknown verifier tier {tier!r}; available: "
                             f"{list(TIERS)}")
        if input_format not in (None, "uint8"):
            raise ValueError(f"unknown input_format {input_format!r}")
        if strict_policy not in ("cpu", "deliver-f32"):
            raise ValueError(f"unknown strict_policy {strict_policy!r}")
        if strict_policy == "deliver-f32" and mode != "strict":
            raise ValueError("strict_policy='deliver-f32' requires "
                             "mode='strict' (envelope mode has no FP32 "
                             "co-run to deliver; use tier='gpu-f32')")
        if tier == "gpu-f32" and mode == "strict":
            raise ValueError("tier='gpu-f32' applies to envelope mode only: "
                             "strict mode runs the FP32 program on every row "
                             "already, its flagged rows go to the CPU")
        if escalation_budget is not None and escalation_budget < 0:
            raise ValueError("escalation_budget must be >= 0 (or None)")
        self._device = _resolve_device(device)
        self._mode = mode
        kwargs = dict(PRECISION_PRESETS["production"], **precision_overrides)
        common = dict(start_layer=start_layer, preprocess=input_format)
        self._agreement = self._bounds = None
        if mode == "strict":
            self._fast = make_explain_fn(cfg, self._device, **common,
                                         **kwargs)
            self._check = make_explain_fn(cfg, self._device, **common)
            self._agreement = (STRICT_AGREEMENT if agreement is None
                               else agreement)
            self._strict_policy = strict_policy
        else:
            self._fast = make_explain_fn(cfg, self._device, **common,
                                         with_diagnostics=True, **kwargs)
            self._bounds = dict(envelope_bounds or ENVELOPE_BOUNDS)
        self._deep_agreement = (TIER_AGREEMENT if tier_agreement is None
                                else tier_agreement)
        self._verify = make_cpu_exact_fn(cfg, start_layer, fallback_precision,
                                         input_format)
        self._tier_fn = None
        if tier == "gpu-f32":
            self._tier_fn = make_explain_fn(cfg, self._device, **common)
            self._verify_batch = max(int(verify_batch), 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._escalation_budget = escalation_budget
        self._lock = threading.Lock()          # the statistics below
        self._closed = False
        self.reset_stats()
        self._worker = threading.Thread(target=self._drain_loop,
                                        name="guarded-verifier", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ worker

    def _drain_loop(self) -> None:
        """Serve queued rows until the close sentinel. In the gpu-f32 tier
        the rows already waiting for the same model are coalesced into one
        micro-batch; a row of another model taken on the way is kept in a
        local deque and served next, before anything newer (never put back
        on the bounded queue, where it could block the worker)."""
        held: deque = deque()
        closing = False
        while True:
            if held:
                item = held.popleft()
            elif closing:
                return
            else:
                item = self._q.get()
                if item is None:               # close sentinel
                    self._q.task_done()
                    return
            if self._tier_fn is None:
                self._verify_one_cpu(item)
                self._q.task_done()
                continue
            batch = [item]
            for other in list(held):
                if len(batch) == self._verify_batch:
                    break
                if other[1] is item[1]:
                    held.remove(other)
                    batch.append(other)
            while len(batch) < self._verify_batch and not closing:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.task_done()
                    closing = True
                elif nxt[1] is item[1]:
                    batch.append(nxt)
                else:
                    held.append(nxt)
            self._verify_tier_batch(batch)
            for _ in batch:
                self._q.task_done()

    def _verify_one_cpu(self, item) -> None:
        """The exact CPU program on one flagged row (the last tier)."""
        ticket, model, img, index, row, t_enq = item
        t0 = time.monotonic()
        try:
            heat = self._verify(model, img, index)
        except BaseException as e:             # noqa: BLE001
            ticket._fail(row, e)
            with self._lock:
                self._n_errors += 1
            return
        t1 = time.monotonic()
        ticket._deliver(row, heat)
        with self._lock:
            self._waits.append(t0 - t_enq)
            self._services.append(t1 - t0)
            self._busy_s += t1 - t0

    def _verify_tier_batch(self, batch) -> None:
        """The gpu-f32 tier on a micro-batch of flagged rows of one model:
        rows whose FP32 heatmap agrees with the production one are cleared
        with it, the others escalate to the CPU. If the FP32 program raises,
        every row goes to the CPU (a dead tier loses no row)."""
        k = len(batch)
        t0 = time.monotonic()
        imgs = np.stack([b[2] for b in batch])
        idxs = np.asarray([b[3] for b in batch], np.int64)
        pad = self._verify_batch - k
        imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
        idxs = np.concatenate([idxs, np.repeat(idxs[-1:], pad)])
        try:
            heat_f = _to_host(self._tier_fn(batch[0][1], imgs, idxs))[:k]
        except BaseException:                  # noqa: BLE001
            for b in batch:
                self._verify_one_cpu(b)
            return
        fast = np.stack([b[0].heatmaps[b[4]] for b in batch])
        corr = _batch_corr(fast, heat_f)
        t1 = time.monotonic()
        share = (t1 - t0) / k
        for i, b in enumerate(batch):
            ticket, _, _, _, row, t_enq = b
            if corr[i] >= self._deep_agreement:
                ticket._deliver(row, heat_f[i])
                with self._lock:
                    self._waits.append(t0 - t_enq)
                    self._services.append(share)
                    self._busy_s += share
                    self._n_tier_cleared += 1
            else:
                with self._lock:
                    self._n_escalated += 1
                self._verify_one_cpu(b)

    # ------------------------------------------------------------ public

    def _dispatch(self, model, images, indices):
        """Launch the fast program(s) on the device and return their device
        tensors, with no host sync: host inputs go to the device from pinned
        memory, asynchronously."""
        images, indices = (self._to_device(a) for a in (images, indices))
        if self._mode == "strict":
            return (self._fast(model, images, indices),
                    self._check(model, images, indices))
        return self._fast(model, images, indices)

    def _to_device(self, a):
        t = torch.as_tensor(a)
        if self._device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(self._device, non_blocking=True)
        return t

    def _finalize(self, dev, model, imgs_np, idx_np,
                  n_valid: Optional[int]) -> BatchTicket:
        """Copy one dispatched batch to the host, flag its rows, build its
        ticket and queue its flagged rows."""
        delivered = None
        heat, other = _to_host(dev[0]), _to_host(dev[1])
        flagged, score = _guard_flags(self._mode, heat, other,
                                      self._agreement, self._bounds, n_valid)
        if self._mode == "strict" and self._strict_policy == "deliver-f32":
            # the FP32 co-run's heatmap for every flagged row at once; only
            # the rows where FP32 itself disagrees go to the CPU
            delivered = flagged
            heat[delivered] = other[delivered]
            flagged = delivered & (score < self._deep_agreement)
            with self._lock:
                self._n_f32_delivered += int((delivered & ~flagged).sum())
        rows = np.flatnonzero(flagged)
        shed = None
        if self._escalation_budget is not None and len(rows):
            free = max(self._escalation_budget - self._q.qsize(), 0)
            if free < len(rows):
                shed = np.zeros_like(flagged)
                shed[rows[free:]] = True
                rows = rows[:free]
        ticket = BatchTicket(heat, flagged, score, delivered_f32=delivered,
                             shed=shed)
        with self._lock:
            self._n_batches += 1
            self._n_samples += (len(flagged) if n_valid is None
                                else int(n_valid))
            self._n_flagged += int(flagged.sum())
            self._n_shed += int(shed.sum()) if shed is not None else 0
            self._depths.append(self._q.qsize())
        for r in rows:
            self._q.put((ticket, model, imgs_np[r], idx_np[r], int(r),
                         time.monotonic()))
        return ticket

    def submit(self, model, images, indices,
               n_valid: Optional[int] = None) -> BatchTicket:
        """Serve one batch: its ticket holds the fast heatmaps; flagged rows
        are queued (``ticket.wait()`` blocks until they are verified). This
        waits for the device each batch; :meth:`serve_stream` does not."""
        if self._closed:
            raise RuntimeError("GuardedServer is closed")
        imgs_np, idx_np = _to_host(images), _to_host(indices)
        dev = self._dispatch(model, imgs_np, idx_np)
        return self._finalize(dev, model, imgs_np, idx_np, n_valid)

    def serve_stream(self, model, batch_iter, depth: int = 4):
        """Yield one ticket per batch of ``batch_iter`` (``(images, indices)``
        or ``(images, indices, n_valid)``), in order, keeping up to ``depth``
        batches launched on the device ahead of the oldest one's copy to the
        host."""
        if self._closed:
            raise RuntimeError("GuardedServer is closed")
        pending: deque = deque()
        for item in batch_iter:
            imgs_np, idx_np = _to_host(item[0]), _to_host(item[1])
            n_valid = item[2] if len(item) > 2 else None
            pending.append((self._dispatch(model, imgs_np, idx_np), imgs_np,
                            idx_np, n_valid))
            if len(pending) > depth:
                dev, im, ix, nv = pending.popleft()
                yield self._finalize(dev, model, im, ix, nv)
        while pending:
            dev, im, ix, nv = pending.popleft()
            yield self._finalize(dev, model, im, ix, nv)

    def warmup(self, model, image, index: int = -1) -> None:
        """Run the verifier tiers once (the FP32 micro-batch and the CPU
        program, which copies the model to the host), so that the first
        flagged row does not pay for it. ``image`` is one sample in the
        server's wire format."""
        img = _to_host(image)
        if self._tier_fn is not None:
            imgs = np.repeat(img[None], self._verify_batch, axis=0)
            idxs = np.full((self._verify_batch,), index, np.int64)
            _to_host(self._tier_fn(model, imgs, idxs))
        self._verify(model, img, index)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every queued row is verified."""
        if timeout is None:
            self._q.join()
            return
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)
        if self._q.unfinished_tasks:
            raise TimeoutError("verification queue did not drain in time")

    def reset_stats(self) -> None:
        """Zero the counters and latency samples (after a warm-up)."""
        with self._lock:
            self._waits: list = []             # enqueue -> verify start
            self._services: list = []          # verify start -> done
            self._depths: list = []            # queue depth at enqueue
            self._busy_s = 0.0
            self._n_samples = self._n_flagged = self._n_batches = 0
            self._n_errors = 0
            self._n_tier_cleared = self._n_escalated = 0
            self._n_f32_delivered = self._n_shed = 0
            self._t_open = time.monotonic()

    def stats(self) -> dict:
        """The queue's statistics since the last reset (times in seconds;
        JAX's keys and meanings)."""
        with self._lock:
            waits = np.asarray(self._waits, np.float64)
            services = np.asarray(self._services, np.float64)
            depths = np.asarray(self._depths, np.float64)
            wall = time.monotonic() - self._t_open
            out = {
                "n_batches": self._n_batches,
                "n_samples": self._n_samples,
                "n_flagged": self._n_flagged,
                "n_errors": self._n_errors,
                "n_tier_cleared": self._n_tier_cleared,
                "n_escalated": self._n_escalated,
                "n_f32_delivered": self._n_f32_delivered,
                "n_shed": self._n_shed,
                "flag_rate": (self._n_flagged / self._n_samples
                              if self._n_samples else 0.0),
                "verifier_busy_s": self._busy_s,
                "wall_s": wall,
                "verifier_busy_frac": self._busy_s / wall if wall else 0.0,
                "queue_depth_max": float(depths.max()) if depths.size else 0.0,
                "queue_depth_mean": (float(depths.mean())
                                     if depths.size else 0.0),
            }
        for name, arr in (("queue_wait", waits), ("service", services)):
            if arr.size:
                out[f"{name}_mean_s"] = float(arr.mean())
                out[f"{name}_p50_s"] = float(np.percentile(arr, 50))
                out[f"{name}_p95_s"] = float(np.percentile(arr, 95))
                out[f"{name}_max_s"] = float(arr.max())
        return out

    def close(self) -> None:
        """Finish the queued work and stop the worker."""
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(None)
        self._worker.join()

    def __enter__(self) -> "GuardedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["TIER_AGREEMENT", "TIERS", "BatchTicket", "GuardedServer"]
