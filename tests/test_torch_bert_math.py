"""The plain versions of the BERT layer kernels B7, B8 and B9 against the JAX
package on the CPU.

Float64 throughout (the JAX side with x64 on), the same numpy-seeded inputs
both ways, a batch of two samples whose attention masks cut at different
lengths. The JAX side runs its jnp paths (``use_pallas=False``, one sample
at a time). Product modes: ``bfloat16``, ``tensorfloat32`` (the weights as
(hi, lo) pairs) and the ``production`` preset's mix; every anchor form.
Tolerance rtol 1e-9 / atol 1e-12: the bf16 roundings of ``_kdot`` are
reproduced exactly, so only the float64 summation order differs (the port
stacks q, k and v into one product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_explainability_tpu.ops import pallas_kernels as pk
from transformer_explainability_torch.ops import bert_math as bmath
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as P

RTOL, ATOL = 1e-9, 1e-12
B, S, H, HD, I = 2, 21, 4, 6, 48
D = H * HD
EPS = 1e-12
MASKED = (3, 8)           # padded tail of each sample
MASK_VALUE = -10000.0

# (mxu, attn_mxu, rule_mxu, mlp_mxu) as the JAX BERT kernel path resolves
# them (bert.forward_collect / reverse_pass)
MODES = {
    "bfloat16": ("bfloat16", "bfloat16", "bfloat16", None),
    "tensorfloat32": ("tensorfloat32", "tensorfloat32", "tensorfloat32",
                      None),
    "production": ("tensorfloat32", "float32", "bfloat16", "bfloat16"),
}


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


def layer_arrays(seed, d=D, inter=I):
    """One BERT layer's parameters (JAX layout: kernels (in, out))."""
    rng = np.random.RandomState(seed)

    def lin(i, o):
        return {"kernel": rng.randn(i, o) / np.sqrt(i),
                "bias": 0.1 * rng.randn(o)}

    def ln():
        return {"scale": 1.0 + 0.1 * rng.randn(d), "bias": 0.1 * rng.randn(d)}

    return {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
            "attn_out": lin(d, d), "attn_ln": ln(), "inter": lin(d, inter),
            "out": lin(inter, d), "out_ln": ln()}


def port_params(arrs, mode):
    """The same layer as :class:`BertLayerParams`, weights prepared for
    ``mode`` (q, k, v stacked)."""
    t = lambda a: torch.from_numpy(np.asarray(a))
    w = lambda *names: P.prepare_weight(
        t(np.concatenate([arrs[n]["kernel"] for n in names], axis=1).T), mode)
    b_qkv = np.concatenate([arrs[n]["bias"] for n in ("q", "k", "v")])
    return bmath.BertLayerParams(
        t(arrs["attn_ln"]["scale"]), t(arrs["attn_ln"]["bias"]),
        t(arrs["out_ln"]["scale"]), t(arrs["out_ln"]["bias"]), t(b_qkv),
        t(arrs["attn_out"]["bias"]), t(arrs["inter"]["bias"]),
        t(arrs["out"]["bias"]), w("q", "k", "v"), w("attn_out"), w("inter"),
        w("out"))


def ext_masks(masked=MASKED, s=S):
    m = np.ones((len(masked), s))
    for i, k in enumerate(masked):
        m[i, s - k:] = 0.0
    return (1.0 - m) * MASK_VALUE


def _jlp(arrs):
    return jax.tree.map(jnp.asarray, arrs)


def _x(seed):
    return np.random.RandomState(seed).randn(B, S, D)


def _jax_fwd(arrs, x, mask, mode, **save):
    mxu, attn, _, mlp = MODES[mode]
    outs = [pk.bert_layer_fwd_core(
        jnp.asarray(x[i]), jnp.asarray(mask[i]), _jlp(arrs), H, HD, EPS,
        mxu=mxu, attn_mxu=attn, mlp_mxu=mlp, use_pallas=False, **save)
        for i in range(B)]
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]


FWD_FORMS = [dict(), dict(save_attn=True),
             dict(save_attn=True, save_probs=True),
             dict(save_attn=True, save_mlp=True),
             dict(save_attn=True, save_probs=True, save_mlp=True)]


@pytest.mark.parametrize("form", range(len(FWD_FORMS)))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bert_layer_fwd_core_plain_matches_jax(x64, mode, form):
    save = FWD_FORMS[form]
    mxu, attn, _, mlp = MODES[mode]
    arrs, x, mask = layer_arrays(1), _x(2), ext_masks()
    got = bmath.bert_layer_fwd_core_plain(
        torch.from_numpy(x), torch.from_numpy(mask), port_params(arrs, mxu),
        H, HD, EPS, mxu, attn, mlp, **save)
    want = _jax_fwd(arrs, x, mask, mode, **save)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"output {k}")


@pytest.mark.parametrize("saved", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bert_out_rev_core_plain_matches_jax(x64, mode, saved):
    mxu, _, rule, mlp = MODES[mode]
    arrs = layer_arrays(3)
    fwd = _jax_fwd(arrs, _x(4), ext_masks(), mode, save_attn=True,
                   save_mlp=True)
    att_ln, mlp_anchors = fwd[1], fwd[5:7]
    rng = np.random.RandomState(5)
    g_out, R = rng.randn(B, S, D), rng.randn(B, S, D)
    t = torch.from_numpy
    got = bmath.bert_out_rev_core_plain(
        t(att_ln), t(g_out), t(R), port_params(arrs, mxu), EPS, mxu, rule,
        mlp, tuple(map(t, mlp_anchors)) if saved else None)
    for i in range(B):
        want = pk.bert_out_rev_core(
            jnp.asarray(att_ln[i]), jnp.asarray(g_out[i]), jnp.asarray(R[i]),
            _jlp(arrs), EPS, mxu=mxu, rule_mxu=rule, mlp_mxu=mlp,
            use_pallas=False,
            saved=tuple(jnp.asarray(a[i]) for a in mlp_anchors)
            if saved else None)
        for g, w, name in zip(got, want, ["g_attln", "R_att"]):
            _close(g[i], w, f"{name}, sample {i}")


@pytest.mark.parametrize("form", ["recompute", "slim", "fat"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bert_attn_rev_core_plain_matches_jax(x64, mode, form):
    mxu, attn, rule, _ = MODES[mode]
    arrs, x, mask = layer_arrays(6), _x(7), ext_masks()
    fwd = _jax_fwd(arrs, x, mask, mode, save_attn=True, save_probs=True)
    # (out, att_ln, qkv_pre, dots, probs, ctx, dense_nb)
    saved = {"recompute": None, "slim": (fwd[2], fwd[5], fwd[6]),
             "fat": tuple(fwd[2:7])}[form]
    rng = np.random.RandomState(8)
    g_attln, R_att = rng.randn(B, S, D), rng.randn(B, S, D)
    t = torch.from_numpy
    got = bmath.bert_attn_rev_core_plain(
        t(x), t(g_attln), t(R_att), t(mask), port_params(arrs, mxu), H, HD,
        EPS, mxu, attn, rule,
        None if saved is None else tuple(map(t, saved)))
    for i in range(B):
        want = pk.bert_attn_rev_core(
            jnp.asarray(x[i]), jnp.asarray(g_attln[i]), jnp.asarray(R_att[i]),
            jnp.asarray(mask[i]), _jlp(arrs), H, HD, EPS, mxu=mxu,
            attn_mxu=attn, rule_mxu=rule, use_pallas=False,
            saved=None if saved is None
            else tuple(jnp.asarray(a[i]) for a in saved))
        for g, w, name in zip(got, want, ["g_in", "R_in", "gc"]):
            _close(g[i], w, f"{name}, sample {i}")


def test_ln_bwd_math_matches_jax(x64):
    rng = np.random.RandomState(9)
    g, x, s = rng.randn(3, 5, D), rng.randn(3, 5, D), rng.randn(D)
    got = bmath.ln_bwd_math(*map(torch.from_numpy, (g, x, s)), 1e-6)
    want = pk._ln_bwd_math(*map(jnp.asarray, (g, x, s)), 1e-6)
    _close(got, want)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    arrs, x, mask = layer_arrays(10), _x(11), ext_masks()
    mxu, attn, rule, mlp = MODES["production"]
    p = port_params(arrs, mxu)
    t = torch.from_numpy
    K.reset_launch_counts()
    fwd = K.bert_layer_fwd_core(t(x), t(mask), p, H, HD, EPS, mxu, attn, mlp,
                                save_attn=True)
    want = bmath.bert_layer_fwd_core_plain(t(x), t(mask), p, H, HD, EPS, mxu,
                                           attn, mlp, save_attn=True)
    assert len(fwd) == 5
    for a, b in zip(fwd, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g, R = t(_x(12)), t(_x(13))
    out = K.bert_out_rev_core(fwd[1], g, R, p, EPS, mxu, rule, mlp)
    att = K.bert_attn_rev_core(t(x), out[0], out[1], t(mask), p, H, HD, EPS,
                               mxu, attn, rule, fwd[2:])
    assert tuple(att[2].shape) == (B, S, S)
    assert all(v == 0 for v in K.launch_counts().values())
    with pytest.raises(ValueError, match="bert_attn_rev_core"):
        K.bert_attn_rev_core(t(x), out[0], out[1], t(mask[:, :5]), p, H, HD,
                             EPS, mxu, attn, rule, fwd[2:])
