"""The port's tensor-parallel program on a distilled DeiT config (the DIST
token and its head) against the JAX package.

The port runs in k = 1, 2, 4 gloo processes (``tests/torch_tp_worker.py``,
through ``tests/test_torch_tp_explain.py``'s spawner) on the tiny distilled
config of ``tests/test_torch_vit_configs.py``, float64, and is held to JAX's
*single-device* ``explain_single`` at rtol 1e-8: JAX's own TP program seeds
the explanation from the CLS head alone on a distilled model, which is
another logit than its single device explains (ROADMAP C3), and the port
does not copy that. The ``production`` preset is held to the port's own
k = 1 run at the same tolerance (sharding only re-associates float64 sums).
"""

import numpy as np
import pytest
import torch

from test_torch_tp_explain import _run_ranks
from test_torch_vit_configs import (ATOL, DIST, RTOL, _inputs, _jax_batch,
                                    _weights, x64)  # noqa: F401
from transformer_explainability_torch.explain.generator import (
    precision_kwargs)


@pytest.fixture(scope="module")
def dist():
    import jax
    jax.config.update("jax_enable_x64", True)
    try:
        return _weights(DIST)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def tp_ranks(dist, tmp_path_factory):
    """k -> rank 0's results of the distilled TP job (float32 and
    production), run once per k."""
    _, _, sd = dist
    imgs, idx = _inputs(DIST, 3)
    cache = {}

    def get(k):
        if k not in cache:
            job = dict(cfg=DIST, params=sd, images=torch.from_numpy(imgs),
                       indices=torch.from_numpy(idx),
                       runs={"f32": {}, "mesh": {"mesh": True},
                             "production": {"kw": precision_kwargs(
                                 "production")}})
            cache[k] = _run_ranks(tmp_path_factory.mktemp(f"dist{k}"), k,
                                  job)[0]
        return cache[k]
    return get


@pytest.mark.parametrize("k", [1, 2, 4])
def test_distilled_tp_matches_jax_single_device_f64(x64, dist, tp_ranks, k):
    """Held to JAX's single-device explanation, not to JAX's TP program,
    which explains the CLS head alone on a distilled model (ROADMAP C3)."""
    jcfg, params, _ = dist
    imgs, idx = _inputs(DIST, 3)
    got = tp_ranks(k)["f32"]
    assert got.shape == (3, 16) and got.dtype == torch.float64
    want = _jax_batch(jcfg, params, imgs, idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if k > 1:
        assert torch.equal(tp_ranks(k)["mesh"], got)


@pytest.mark.parametrize("k", [2, 4])
def test_distilled_tp_production_at_k_equals_k1(tp_ranks, k):
    got, want = tp_ranks(k)["production"], tp_ranks(1)["production"]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
