"""The port's serving queue, ``explain.serving.GuardedServer``, case by case
as the JAX package's ``tests/test_serving.py`` holds JAX's, on the CPU
(``device="cpu"``; the ``gpu-f32`` tier's program runs where the server's
device is).

JAX's configuration and inputs; the same weights both ways
(``vit_params_from_jax``). Rows the exact CPU program corrects are held to
JAX's float32 program at JAX's tolerance (rtol 1e-5, atol 1e-7); rows the
server keeps or delivers from one of its own programs are held bitwise to
that program. On the CPU the port's ``production`` rounds its products as
the card does, where JAX's runs exact float32, so strict mode's flags are
forced as JAX's tests force them. The last cases are the regressions of the
JAX faults the port does not copy (ROADMAP C3): the worker's re-enqueue, the
ticket's unlocked count.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.explain import generator as jgen
from transformer_explainability_tpu.explain import serving as jserving
from transformer_explainability_tpu.models import vit as jvit
from transformer_explainability_torch.explain import generator as tgen
from transformer_explainability_torch.explain import serving
from transformer_explainability_torch.explain.serving import (BatchTicket,
                                                              GuardedServer)
from transformer_explainability_torch.models import vit as tvit
from transformer_explainability_torch.params.convert import (
    vit_params_from_jax)

SMALL = dict(img_size=32, embed_dim=64, depth=3, num_heads=4, num_classes=10)
JCFG = dataclasses.replace(jvit.VIT_BASE_16_224, **SMALL)
CFG = dataclasses.replace(tvit.VIT_BASE_16_224, **SMALL)
RTOL, ATOL = 1e-5, 1e-7
FLAG_ALL = {f: (np.inf, -np.inf) for f in tgen.DIAG_FIELDS}
PROD = tgen.precision_kwargs("production")
F32_BASE = dict(matmul_precision="float32", relprop_precision=None,
                attn_precision=None, mlp_precision=None)
TIMEOUT = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(sd):
    m = tvit.VisionTransformer(CFG, device="cpu")
    m.load_state_dict(sd)
    m.requires_grad_(False)
    return m


@pytest.fixture(scope="module")
def setup():
    params = jvit.init_params(jax.random.PRNGKey(0), JCFG)
    model = _model(vit_params_from_jax(jax.tree.map(np.asarray, params), CFG))
    rng = np.random.RandomState(0)
    imgs = rng.randn(4, 3, 32, 32).astype(np.float32)
    idx = np.array([1, -1, 3, 0])
    want = np.asarray(jgen.make_explain_fn(JCFG, "transformer_attribution")(
        params, jnp.asarray(imgs), jnp.asarray(idx)))
    return model, imgs, idx, want


def _fast(model, imgs, idx):
    """The envelope server's fast program: production with diagnostics."""
    heat, diag = tgen.make_explain_fn(CFG, "cpu", with_diagnostics=True,
                                      **PROD)(model, imgs, idx)
    return heat.numpy(), diag.numpy()


def _f32(model, imgs, idx, preprocess=None):
    return tgen.make_explain_fn(CFG, "cpu", preprocess=preprocess)(
        model, imgs, idx).numpy()


def test_tier_constant_and_names():
    """TIER_AGREEMENT is JAX's; the tier JAX calls "tpu-f32" is "gpu-f32"
    here, and no alias takes the old name."""
    assert serving.TIER_AGREEMENT == jserving.TIER_AGREEMENT
    assert serving.TIERS == ("cpu", "gpu-f32")
    with pytest.raises(ValueError):
        GuardedServer(CFG, "cpu", tier="tpu-f32")


def test_server_no_flags_queue_stays_empty(setup):
    """Bounds calibrated on the traffic itself: nothing flagged, the ticket
    is done at once, heatmaps bitwise the fast program's."""
    model, imgs, idx, _ = setup
    heat, diag = _fast(model, imgs, idx)
    bounds = tgen.calibrate_envelope(diag, margin=1.5)
    with GuardedServer(CFG, "cpu", envelope_bounds=bounds) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.done and not t.flagged.any() and not t.corrections
        np.testing.assert_array_equal(t.heatmaps, heat)
        s = srv.stats()
    assert s["n_flagged"] == 0 and s["queue_depth_max"] == 0.0


def test_server_corrections_spliced_async(setup):
    """Every row flagged: wait() completes, every row is the exact CPU
    program's (held to JAX's float32 program), the stats count the work."""
    model, imgs, idx, want = setup
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.flagged.all()
        assert t.wait(timeout=TIMEOUT)
        np.testing.assert_allclose(t.heatmaps, want, rtol=RTOL, atol=ATOL)
        assert sorted(t.corrections) == [0, 1, 2, 3]
        s = srv.stats()
    assert s["n_flagged"] == 4 and s["n_samples"] == 4
    assert s["flag_rate"] == 1.0
    assert s["service_mean_s"] > 0 and s["verifier_busy_s"] > 0


def test_server_multi_batch_sustained(setup):
    """Three batches in flight: corrections land on their tickets, drain()
    empties the queue, the pad row (n_valid=3) keeps the fast heatmap."""
    model, imgs, idx, want = setup
    heat, _ = _fast(model, imgs, idx)
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL) as srv:
        tickets = [srv.submit(model, imgs, idx, n_valid=3) for _ in range(3)]
        srv.drain(timeout=TIMEOUT)
        for t in tickets:
            assert t.done and sorted(t.corrections) == [0, 1, 2]
            np.testing.assert_allclose(t.heatmaps[:3], want[:3], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_array_equal(t.heatmaps[3], heat[3])
        s = srv.stats()
    assert s["n_batches"] == 3 and s["n_samples"] == 9
    assert s["n_flagged"] == 9
    assert s["queue_wait_p95_s"] >= s["queue_wait_p50_s"] >= 0


def test_server_strict_mode_no_flags_at_the_float32_base(setup):
    """Strict mode with the fast program at the float32 base: it is the
    verifier's program, nothing is flagged (JAX's CPU case, where its
    production program is exact float32)."""
    model, imgs, idx, _ = setup
    with GuardedServer(CFG, "cpu", mode="strict", **F32_BASE) as srv:
        t = srv.submit(model, imgs, idx)
        assert not t.flagged.any() and t.done
        np.testing.assert_array_equal(t.heatmaps, _f32(model, imgs, idx))
    assert srv.stats()["n_flagged"] == 0


def test_serve_stream_matches_submit(setup):
    """Pipelined serving gives the tickets of a submit loop (order,
    heatmaps, flags, corrections) at any depth."""
    model, imgs, idx, want = setup
    batches = [(imgs, idx), (imgs[::-1], idx[::-1]), (imgs, idx, 2)]
    for depth in (1, 2, 8):
        with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL) as srv:
            tickets = list(srv.serve_stream(model, iter(batches),
                                            depth=depth))
            srv.drain(timeout=TIMEOUT)
        with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL) as srv:
            loop = [srv.submit(model, *b[:2], *b[2:]) for b in batches]
            srv.drain(timeout=TIMEOUT)
        assert len(tickets) == 3
        for t, u in zip(tickets, loop):
            np.testing.assert_array_equal(t.heatmaps, u.heatmaps)
            np.testing.assert_array_equal(t.flagged, u.flagged)
            assert sorted(t.corrections) == sorted(u.corrections)
        np.testing.assert_allclose(tickets[0].heatmaps, want, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(tickets[1].heatmaps, want[::-1],
                                   rtol=RTOL, atol=ATOL)
        assert sorted(tickets[2].corrections) == [0, 1]
        assert srv.stats()["n_samples"] == 4 + 4 + 2


@pytest.mark.parametrize("call", ["submit", "serve_stream"])
def test_closed_server_rejects_work(setup, call):
    model, imgs, idx, _ = setup
    srv = GuardedServer(CFG, "cpu", mode="strict")
    srv.close()
    with pytest.raises(RuntimeError):
        if call == "submit":
            srv.submit(model, imgs, idx)
        else:
            list(srv.serve_stream(model, [(imgs, idx)]))
    srv.close()                                # idempotent


def test_server_verifier_failure_never_hangs(setup):
    """A raising verifier neither kills the worker nor hangs wait():
    failed rows keep the fast heatmap, record the error, stay flagged."""
    model, imgs, idx, _ = setup
    heat, _ = _fast(model, imgs, idx)
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL) as srv:
        calls = {"n": 0}
        real = srv._verify

        def flaky(m, im, ix):
            calls["n"] += 1
            if calls["n"] % 2 == 1:
                raise RuntimeError("verifier crash")
            return real(m, im, ix)

        srv._verify = flaky
        t = srv.submit(model, imgs, idx)
        assert t.wait(timeout=TIMEOUT)
        assert sorted(t.errors) == [0, 2]
        assert sorted(t.corrections) == [1, 3]
        np.testing.assert_array_equal(t.heatmaps[0], heat[0])
        s = srv.stats()
    assert s["n_errors"] == 2


# ---------------------------------------------------------------- tiers


def test_tier_f32_clears_benign_flags(setup):
    """tier='gpu-f32': flagged rows whose production heatmap agrees with the
    FP32 one are cleared with the FP32 heatmap in one micro-batch, no
    escalation."""
    model, imgs, idx, want = setup
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL, tier="gpu-f32",
                       verify_batch=4) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.flagged.all()
        assert t.wait(timeout=TIMEOUT)
        np.testing.assert_array_equal(t.heatmaps, _f32(model, imgs, idx))
        np.testing.assert_allclose(t.heatmaps, want, rtol=RTOL, atol=ATOL)
        s = srv.stats()
    assert s["n_tier_cleared"] == 4 and s["n_escalated"] == 0


def test_tier_f32_escalates_on_disagreement(setup):
    """An impossible tier agreement sends every flagged row on to the exact
    CPU program."""
    model, imgs, idx, want = setup
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL, tier="gpu-f32",
                       tier_agreement=2.0, verify_batch=3) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.wait(timeout=TIMEOUT)
        np.testing.assert_allclose(t.heatmaps, want, rtol=RTOL, atol=ATOL)
        s = srv.stats()
    assert s["n_escalated"] == 4 and s["n_tier_cleared"] == 0
    assert sorted(t.corrections) == [0, 1, 2, 3]


def test_tier_f32_program_failure_falls_back_to_cpu(setup):
    """A dying tier program loses no row: the micro-batch goes to the CPU
    row by row, counted neither cleared nor escalated."""
    model, imgs, idx, want = setup
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL,
                       tier="gpu-f32") as srv:
        def dead(*a):
            raise RuntimeError("device lost")
        srv._tier_fn = dead
        t = srv.submit(model, imgs, idx)
        assert t.wait(timeout=TIMEOUT)
        np.testing.assert_allclose(t.heatmaps, want, rtol=RTOL, atol=ATOL)
        s = srv.stats()
    assert s["n_errors"] == 0 and s["n_tier_cleared"] == 0
    assert s["n_escalated"] == 0
    assert sorted(t.corrections) == [0, 1, 2, 3]


def test_server_rejects_bad_arguments():
    with pytest.raises(ValueError):
        GuardedServer(CFG, "cpu", mode="strict", tier="gpu-f32")
    with pytest.raises(ValueError):
        GuardedServer(CFG, "cpu", tier="gpu")
    with pytest.raises(ValueError):
        GuardedServer(CFG, "cpu", input_format="float16")
    with pytest.raises(ValueError):
        GuardedServer(CFG, "cpu", mode="envelope",
                      strict_policy="deliver-f32")
    with pytest.raises(ValueError):
        GuardedServer(CFG, "cpu", mode="strict", strict_policy="f64")
    with pytest.raises(ValueError):
        GuardedServer(CFG, "cpu", escalation_budget=-1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            GuardedServer(CFG)                 # the card by default


def test_strict_deliver_f32_policy(setup):
    """strict_policy='deliver-f32': every flagged row is replaced at once
    by the FP32 co-run's heatmap (no queue); only deep-disagreement rows
    would go to the CPU (none at tier_agreement -2)."""
    model, imgs, idx, want = setup
    with GuardedServer(CFG, "cpu", mode="strict", strict_policy="deliver-f32",
                       agreement=2.0, tier_agreement=-2.0) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.done and not t.flagged.any()
        assert t.delivered_f32 is not None and t.delivered_f32.all()
        np.testing.assert_array_equal(t.heatmaps, _f32(model, imgs, idx))
        np.testing.assert_allclose(t.heatmaps, want, rtol=RTOL, atol=ATOL)
        s = srv.stats()
    assert s["n_f32_delivered"] == 4 and s["n_flagged"] == 0


def test_strict_deliver_f32_deep_rows_escalate(setup):
    """tier_agreement 2.0 makes every flagged row deep: all go to the CPU
    and come back as the exact program's."""
    model, imgs, idx, want = setup
    with GuardedServer(CFG, "cpu", mode="strict", strict_policy="deliver-f32",
                       agreement=2.0, tier_agreement=2.0) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.flagged.all()
        assert t.wait(timeout=TIMEOUT)
        np.testing.assert_allclose(t.heatmaps, want, rtol=RTOL, atol=ATOL)
        assert sorted(t.corrections) == [0, 1, 2, 3]
        s = srv.stats()
    assert s["n_f32_delivered"] == 0 and s["n_flagged"] == 4


# ------------------------------------------------------ uint8 wire format


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(7)
    u8 = rng.randint(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
    host = (u8.astype(np.float32) / np.float32(255.0)) - np.float32(0.5)
    return u8, (host / np.float32(0.5)).transpose(0, 3, 1, 2)


def test_preprocess_uint8_matches_host_normalization(setup, frames):
    """preprocess='uint8' on raw frames is the default program on frames
    normalised on the host in float32: bitwise (the same correctly rounded
    divides)."""
    model, _, idx, _ = setup
    u8, host = frames
    np.testing.assert_array_equal(_f32(model, u8, idx, "uint8"),
                                  _f32(model, host, idx))


@pytest.mark.parametrize("tier_agreement", [-2.0, 2.0])
def test_server_uint8_wire_format_end_to_end(setup, frames, tier_agreement):
    """input_format='uint8': the fast program, the tier and the exact CPU
    program all take the raw frames; cleared rows (tier agreement -2) are
    the FP32 program's on them, escalated rows (2) the uint8 CPU
    verifier's. (The port's production disagrees with FP32 below
    TIER_AGREEMENT on one of these frames, where JAX's CPU production is
    FP32 itself.)"""
    model, _, idx, _ = setup
    u8, _ = frames
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL, tier="gpu-f32",
                       input_format="uint8", verify_batch=4,
                       tier_agreement=tier_agreement) as srv:
        srv.warmup(model, u8[0], -1)
        t = srv.submit(model, u8, idx)
        assert t.wait(timeout=TIMEOUT)
        s = srv.stats()
    if tier_agreement < 0:
        assert s["n_tier_cleared"] == 4
        np.testing.assert_array_equal(t.heatmaps,
                                      _f32(model, u8, idx, "uint8"))
    else:
        assert s["n_escalated"] == 4
        exact = tgen.make_cpu_exact_fn(CFG, preprocess="uint8")
        for i in range(4):
            np.testing.assert_array_equal(t.heatmaps[i],
                                          exact(model, u8[i], idx[i]))


# ------------------------------------------- verifier cache thread-safety


def test_cpu_exact_fn_concurrent_first_call(setup, monkeypatch):
    """The caller's warmup and the worker's first verification fill the
    exact program's model copy at the same time: one copy, no error (the
    JAX round-5e race; the copy's load is slowed to hold the window
    open)."""
    model, imgs, idx, want = setup
    real_load = tvit.VisionTransformer.load_state_dict
    loads = []

    def slow_load(self, sd, *a, **kw):
        loads.append(1)
        time.sleep(0.5)
        return real_load(self, sd, *a, **kw)

    monkeypatch.setattr(tvit.VisionTransformer, "load_state_dict", slow_load)
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL) as srv:
        t = srv.submit(model, imgs, idx)
        srv.warmup(model, imgs[0], 1)
        assert t.wait(timeout=TIMEOUT)
        s = srv.stats()
    assert s["n_errors"] == 0 and len(loads) == 1
    np.testing.assert_allclose(t.heatmaps, want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------- escalation load-shedding


def test_escalation_budget_zero_sheds_everything(setup):
    """budget 0: no row is queued, the ticket is done at once, rows keep
    their delivered (FP32) heatmaps and are all marked shed."""
    model, imgs, idx, want = setup
    with GuardedServer(CFG, "cpu", mode="strict", strict_policy="deliver-f32",
                       agreement=2.0, tier_agreement=2.0,
                       escalation_budget=0) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.done and not t.corrections
        assert t.shed is not None and t.shed.all() and t.flagged.all()
        np.testing.assert_array_equal(t.heatmaps, _f32(model, imgs, idx))
        np.testing.assert_allclose(t.heatmaps, want, rtol=RTOL, atol=ATOL)
        s = srv.stats()
    assert s["n_shed"] == 4 and s["n_flagged"] == 4


def test_escalation_budget_partial(setup):
    """budget 2 with 4 flagged rows: 2 verified, 2 shed."""
    model, imgs, idx, _ = setup
    with GuardedServer(CFG, "cpu", mode="strict", strict_policy="deliver-f32",
                       agreement=2.0, tier_agreement=2.0,
                       escalation_budget=2) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.shed is not None and int(t.shed.sum()) == 2
        assert t.wait(timeout=TIMEOUT)
        assert set(t.corrections) == set(np.flatnonzero(~t.shed).tolist())
        s = srv.stats()
    assert s["n_shed"] == 2 and s["n_flagged"] == 4


def test_escalation_budget_envelope_mode(setup):
    """Envelope mode, budget 0: a done ticket with the fast heatmaps."""
    model, imgs, idx, _ = setup
    heat, _ = _fast(model, imgs, idx)
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL,
                       escalation_budget=0) as srv:
        t = srv.submit(model, imgs, idx)
        assert t.done and t.shed is not None and t.shed.all()
        np.testing.assert_array_equal(t.heatmaps, heat)
        s = srv.stats()
    assert s["n_shed"] == 4


# ------------------------------------- the JAX faults not carried over (C3)


def _other_model(model):
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["blocks.0.attn.proj.weight"] *= 2.0
    return _model(sd)


def test_tier_full_queue_of_two_models_drains(setup):
    """A tier server with max_queue=1 serving two models' flagged rows in
    turn: JAX's worker puts a row of the other model back on its own full
    queue and can wait there forever; this one keeps it aside and serves it
    next. Every ticket completes with its own model's FP32 heatmaps."""
    model, imgs, idx, _ = setup
    models = [model, _other_model(model)]
    tickets, errs = [], []
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL, tier="gpu-f32",
                       tier_agreement=-2.0, verify_batch=4,
                       max_queue=1) as srv:
        def produce():
            try:
                for k in range(6):
                    tickets.append(srv.submit(models[k % 2], imgs, idx))
            except Exception as e:             # noqa: BLE001
                errs.append(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        producer.join(timeout=TIMEOUT)
        assert not producer.is_alive(), "the submitter is blocked"
        srv.drain(timeout=TIMEOUT)
        s = srv.stats()
    assert not errs and len(tickets) == 6
    assert s["n_tier_cleared"] == s["n_flagged"] == 24
    assert s["n_escalated"] == s["n_errors"] == 0
    f32 = [_f32(m, imgs, idx) for m in models]
    assert not np.allclose(f32[0], f32[1], rtol=RTOL, atol=ATOL)
    for k, t in enumerate(tickets):
        assert t.done and sorted(t.corrections) == [0, 1, 2, 3]
        np.testing.assert_allclose(t.heatmaps, f32[k % 2], rtol=RTOL,
                                   atol=ATOL)


def test_worker_serves_a_held_row_next(setup):
    """A row of another model met while coalescing a micro-batch is served
    right after it, before the rows queued later (JAX re-enqueues it at the
    back of the queue)."""
    model, imgs, idx, _ = setup
    other = _other_model(model)
    gate, calls = threading.Event(), []
    with GuardedServer(CFG, "cpu", envelope_bounds=FLAG_ALL, tier="gpu-f32",
                       verify_batch=4) as srv:
        real = srv._tier_fn

        def recorded(m, im, ix):
            gate.wait(TIMEOUT)
            calls.append(("model" if m is model else "other",
                          len(np.unique(im.reshape(len(im), -1), axis=0))))
            return real(m, im, ix)

        srv._tier_fn = recorded
        first = srv.submit(model, imgs, idx, n_valid=1)
        while srv._q.qsize():                  # the worker holds row 0
            time.sleep(0.01)
        for m, rows in ((model, slice(1, 2)), (other, slice(2, 3)),
                        (model, slice(3, 4))):
            srv.submit(m, imgs[rows], idx[rows], n_valid=1)
        gate.set()
        srv.drain(timeout=TIMEOUT)
    assert first.done
    assert calls == [("model", 1), ("model", 2), ("other", 1)]


def test_ticket_pending_count_is_locked():
    """Many threads finishing rows of one ticket at once: the count reaches
    0 exactly once, done is set, nothing is lost (JAX's ticket counts down
    without a lock)."""
    n_threads, per = 8, 2000
    t = BatchTicket(np.zeros((n_threads * per, 1)),
                    np.ones(n_threads * per, bool), np.zeros(n_threads * per))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [t._finish_one()
                                                    for _ in range(per)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    assert t._pending == 0 and t.done


def test_guarded_modules_import_no_jax(tmp_path):
    """The guarded functions and the server run in a process where JAX
    cannot be imported (only the tests import both packages)."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None               # any import of it now fails
        import dataclasses
        import numpy as np, torch
        from transformer_explainability_torch.explain import (
            bert_generator, generator, serving)
        from transformer_explainability_torch.models import vit
        cfg = dataclasses.replace(vit.VIT_BASE_16_224, img_size=32,
                                  embed_dim=16, depth=2, num_heads=2,
                                  num_classes=4)
        sd = vit.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
        model = vit.VisionTransformer(cfg, device="cpu")
        model.load_state_dict(sd)
        imgs = np.random.RandomState(0).randn(2, 3, 32, 32).astype("f4")
        with serving.GuardedServer(cfg, "cpu", mode="strict",
                                   agreement=2.0) as srv:
            t = srv.submit(model, imgs, np.array([0, -1]))
            assert t.wait(60) and sorted(t.corrections) == [0, 1]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path),
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
