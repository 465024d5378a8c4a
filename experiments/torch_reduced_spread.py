"""How far float32 draws of a reduced-base explain path spread, on the card
and on the CPU, on one CUDA card.

    python3 experiments/torch_reduced_spread.py [--witnesses 16] [--draws 8]
                                                [--out chiprun_out/reduced_spread.json]

The models and inputs of ``chip_smoke.py``'s reduced-base phase: ViT-B/16
and BERT-base with the seeded weights drawn on the CPU (``init_params``,
seed 0), ViT's first batch of 8 images from
``experiments/data/fidelity_truth.npz`` and BERT's first seeded batch at
S = 512, with the same argmax indices. For each (method, preset) pair
named in ``PAIRS`` (by default the five that met the phase's median rule
only through a witness in its first run), per sample of the first four,
the Pearson corr against the same port path in float64 on the card of:

  * the card's float32 path (on the batch of 8, as the phase runs it) on
    the weights as they are, and on
    ``--witnesses`` sets of weights each moved to a float32 neighbour, up or
    down at random (seeds 1901, 1902, ...: the first eight are the phase's
    witnesses);
  * the same path in float32 on the CPU, on the weights as they are and on
    ``--draws`` moved sets (seeds 1801, 1802, ...: the first two are the
    phase's plain draws).

If the card and the CPU compute the same float32 function, their draws are
exchangeable: per sample, the share of (card draw, CPU draw) pairs where
the card's is lower is near 0.5, and the card's draw on the weights as
they are ranks anywhere among the card's draws. A card fault that holds on
every draw of the weights pushes every card draw low. Needs no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from transformer_explainability_torch.explain import (  # noqa: E402
    BertExplainer, Explainer)
from transformer_explainability_torch.explain.generator import (  # noqa: E402
    precision_kwargs)
from transformer_explainability_torch.models import bert as bert_mod  # noqa: E402
from transformer_explainability_torch.models.vit import (  # noqa: E402
    VIT_BASE_16_224, init_params)

# (model, label, explainer kwargs, call kwargs)
PAIRS = [
    ("vit", "rollout bfloat16", precision_kwargs("bfloat16"),
     dict(method="rollout")),
    ("vit", "full bfloat16", precision_kwargs("bfloat16"),
     dict(method="full")),
    ("vit", "full production", precision_kwargs("production"),
     dict(method="full")),
    ("vit", "transformer_attribution bfloat16 base, float32 rules",
     dict(matmul_precision="bfloat16", relprop_precision="float32"), {}),
    ("bert", "full production", precision_kwargs("production"),
     dict(method="full")),
]
SAMPLES = 4


def ulp_moved(sd, seed, dev):
    """``sd`` with every float element moved to a float32 neighbour, up or
    down at random (seeded on ``dev``), as ``chip_smoke.py`` moves it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    inf = torch.tensor(float("inf"), device=dev)
    return {k: torch.where(torch.rand(v.shape, generator=g, device=dev)
                           < 0.5, torch.nextafter(v, inf),
                           torch.nextafter(v, -inf))
            if v.is_floating_point() else v for k, v in sd.items()}


def corr_rows(x, y, valid=None):
    """Per-row Pearson corr in float64 on the CPU (``valid``: each row's
    tokens)."""
    x, y = x.double().cpu().reshape(len(x), -1), y.double().cpu().reshape(
        len(y), -1)
    out = []
    for i in range(len(x)):
        a, b = (x[i], y[i]) if valid is None else (x[i][valid[i]],
                                                   y[i][valid[i]])
        a, b = a - a.mean(), b - b.mean()
        out.append(float((a * b).sum() / (a.norm() * b.norm())))
    return np.asarray(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--witnesses", type=int, default=16)
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "reduced_spread.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg, bcfg = VIT_BASE_16_224, bert_mod.BERT_BASE_UNCASED
    data = np.load(os.path.join(ROOT, "experiments/data/fidelity_truth.npz"))
    rows = np.arange(8) % len(data["imgs"])
    idx = data["idx"].astype(np.int64)[rows].copy()
    idx[[1, 5]] = -1
    vit_in = (data["imgs"][rows], idx)
    rng = np.random.RandomState(7)
    lengths = rng.randint(64, 513, size=8)
    lengths[0] = 512
    valid = np.arange(512)[None, :] < lengths[:, None]
    ids = np.where(valid, rng.randint(1000, bcfg.vocab_size, size=(8, 512)),
                   0)
    ids[:, 0] = 101
    bidx = rng.randint(0, bcfg.num_labels, size=8)
    bidx[[1, 5]] = -1
    bert_in = (ids, valid.astype(np.float32), bidx)
    sds = {"vit": init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device=dev),
           "bert": bert_mod.init_params(bcfg, generator=torch.Generator()
                                        .manual_seed(0), device=dev)}
    card = card_line()
    print(f"card: {card}")
    results = []
    for name, label, ekw, ckw in PAIRS:
        t0 = time.perf_counter()
        sd = sds[name]
        if name == "vit":
            make = lambda s, d: Explainer(s, cfg, d, **ekw)
            run = lambda ex, n=8: ex.explain(*(a[:n] for a in vit_in),
                                             **ckw)[:SAMPLES]
            sim = lambda x, y: corr_rows(x, y)
        else:
            make = lambda s, d: BertExplainer(s, bcfg, d, **ekw)
            run = lambda ex, n=8: ex.explain(*(a[:n] for a in bert_in),
                                             **ckw)[:SAMPLES]
            sim = lambda x, y: corr_rows(x, y, torch.as_tensor(
                bert_in[1][:SAMPLES]).bool())
        # as the phase runs them: the card's float32 path on the batch of
        # 8, the float64 path and the CPU's on the first SAMPLES samples
        ref = run(make({k: v.double() if v.is_floating_point() else v
                        for k, v in sd.items()}, "cuda"), SAMPLES)
        card_draws = [sim(run(make(sd, "cuda")), ref)]
        for j in range(1, args.witnesses + 1):
            card_draws.append(sim(run(make(ulp_moved(sd, 1900 + j, dev),
                                            "cuda")), ref))
        cpu_draws = [sim(run(make({k: v.to(cpu) for k, v in sd.items()},
                                  "cpu"), SAMPLES), ref)]
        for j in range(1, args.draws + 1):
            moved = {k: v.to(cpu) for k, v in ulp_moved(sd, 1800 + j,
                                                         dev).items()}
            cpu_draws.append(sim(run(make(moved, "cpu"), SAMPLES), ref))
        kd, pd = np.asarray(card_draws), np.asarray(cpu_draws)
        # per sample: the share of (card, CPU) draw pairs with the card's
        # lower, and the rank of the card's draw as it is among its own
        share = (kd[:, None, :] < pd[None, :, :]).mean(axis=(0, 1))
        rank = (kd[1:] < kd[0]).sum(axis=0)
        med_share = float((np.median(kd, axis=1)[:, None]
                           < np.median(pd, axis=1)[None, :]).mean())
        row = dict(model=name, pair=label, card=kd.tolist(),
                   cpu=pd.tolist(), share_card_lower=share.tolist(),
                   rank_as_is=rank.tolist(), median_share=med_share,
                   seconds=time.perf_counter() - t0)
        results.append(row)
        print(f"{name} {label}: per sample, card as it is "
              f"{np.round(kd[0], 6).tolist()}, rank among its "
              f"{args.witnesses} moved draws (0 = lowest) {rank.tolist()}; "
              f"card draws min/median/max "
              f"{np.round(kd.min(0), 6).tolist()} / "
              f"{np.round(np.median(kd, 0), 6).tolist()} / "
              f"{np.round(kd.max(0), 6).tolist()}; CPU draws min/median/max "
              f"{np.round(pd.min(0), 6).tolist()} / "
              f"{np.round(np.median(pd, 0), 6).tolist()} / "
              f"{np.round(pd.max(0), 6).tolist()}; share of (card, CPU) "
              f"pairs with the card lower {np.round(share, 3).tolist()}, of "
              f"their 4-sample medians {med_share:.3f} "
              f"({row['seconds']:.1f} s)", flush=True)
        del card_draws, cpu_draws
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, witnesses=args.witnesses,
                       draws=args.draws, rows=results), f, indent=1)
    return 0


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0].strip()


if __name__ == "__main__":
    sys.exit(main())
