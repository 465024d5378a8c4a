"""How well-conditioned a BERT method's exact answer is, on one CUDA card.

    python3 experiments/torch_bert_conditioning.py [--methods full ...]
                                                   [--seq 512]

BERT-base with ``chip_smoke.py``'s seeded random weights and its first
batch of 8 padded sequences (the same generators). For each method, per
sample, the Pearson corr over the sample's tokens against the float64 plain
path of:

  * the float32 plain path (exact FP32, TF32 off): what ``chip_smoke.py``
    phase 4 gates;
  * the float64 plain path with every weight moved by about one float32
    ulp (each element times 1 + 2⁻²⁴·u, u uniform in [−1, 1], seeded).

If the second is as far from 1 as the first on a sample, the method's map
there changes with ulp-sized changes of its inputs: exact FP32 cannot be
expected to reach it, whatever the implementation. Needs no JAX.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def first_batch(cfg, S):
    """``chip_smoke.py``'s first BERT batch: ids, 0/1 masks, indices."""
    rng = np.random.RandomState(7)
    lengths = rng.randint(64, S + 1, size=8)
    lengths[0] = S
    valid = np.arange(S)[None, :] < lengths[:, None]
    ids = np.where(valid, rng.randint(1000, cfg.vocab_size, size=(8, S)), 0)
    ids[:, 0] = 101
    idx = rng.randint(0, cfg.num_labels, size=8)
    idx[[1, 5]] = -1
    return ids, valid.astype(np.float32), idx


def token_corr(x, y, valid):
    out = []
    for a, b, v in zip(x.double(), y.double(), valid):
        a, b = a[v], b[v]
        a, b = a - a.mean(), b - b.mean()
        out.append(((a * b).sum() / (a.norm() * b.norm())).item())
    return np.asarray(out)


def main():
    from transformer_explainability_torch.explain import bert_generator as bg
    from transformer_explainability_torch.models import bert as bert_mod
    from transformer_explainability_torch.ops import kernels as K

    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", nargs="+",
                    default=["full", "transformer_attribution"])
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = bert_mod.BERT_BASE_UNCASED
    params = bert_mod.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(99)

    def model_of(sd, dtype):
        model = bert_mod.BertForSequenceClassification(cfg, device=dev,
                                                       dtype=dtype)
        model.load_state_dict({k: v.to(dtype) if v.is_floating_point()
                               else v for k, v in sd.items()})
        return model.requires_grad_(False)

    def moved(v):
        if not v.is_floating_point():
            return v
        u = torch.rand(v.shape, generator=gen, device=dev,
                       dtype=torch.float64) * 2 - 1
        return v.double() * (1 + 2.0 ** -24 * u)

    m32 = model_of(params, torch.float32)
    m64 = model_of(params, torch.float64)
    m64u = model_of({k: moved(v) for k, v in params.items()}, torch.float64)
    ids, valid, idx = (torch.as_tensor(a, device=dev)
                       for a in first_batch(cfg, args.seq))
    keep = valid.bool()
    for method in args.methods:
        kw = dict(method=method, ops=K.BERT_PLAIN_OPS,
                  start_layer=0 if method == "rollout" else 11)
        ref = bg.explain_batch(m64, ids, valid, idx, **kw)
        c32 = token_corr(bg.explain_batch(m32, ids, valid, idx, **kw), ref,
                         keep)
        cu = token_corr(bg.explain_batch(m64u, ids, valid, idx, **kw), ref,
                        keep)
        fmt = lambda a: np.array2string(a, precision=6, max_line_width=1000)
        print(f"[{card}] {method} S={args.seq} corr vs float64 per sample: "
              f"float32 {fmt(c32)}; float64 with weights moved ~1 float32 "
              f"ulp {fmt(cu)}")


if __name__ == "__main__":
    main()
