"""Where the device time goes in the PyTorch port's explanations on one CUDA
card: ViT-B/16, ViT-L/16 or DeiT-base distilled at B=8, or BERT-base at B=8
and sequence length S.

    python3 experiments/torch_profile_vit.py [--model vit|vit_384|vit_large|deit_distilled|bert]
                                             [--seq 512]
                                             [--precision float32|production|bfloat16|tensorfloat32]
                                             [--no-block-kernel] [--method M]
                                             [--tp] [--batches 4] [--out DIR]
    python3 experiments/torch_profile_vit.py [--b2] [--b3] [--b4] [--b5] [--b6]
                                             [--b7] [--b8] [--b9] [--b10a] [--b10b]
                                             [--seq 512] [--precision production]
                                             [--model vit|vit_384|vit_large|deit_distilled]

``--model`` picks the ViT configuration (``vit``: ViT-B/16; ``vit_384``:
ViT-B/16 at 384 px, n = 577, timm's ``vit_base_patch16_384`` geometry;
``vit_large``:
ViT-L/16, 24 blocks at D 1024, h 16, M 4096; ``deit_distilled``: DeiT-base
with its distillation token, n = 198) for the explain paths, ``--tp`` and
the ViT layer kernels, or BERT-base. ``--precision`` names a preset of ``PRECISION_PRESETS`` (default float32:
exact FP32; production and bfloat16 run the block megakernels, or for BERT
the layer kernels; tensorfloat32, raw ``precision_kwargs("tensorfloat32")``:
ViT's megakernels, or with ``--no-block-kernel`` the tf32 split arm, in
their bf16×3 modes). ``--seq`` is BERT's S (at most 512); each sample is
padded to its own length, seeded. ``--no-block-kernel`` takes ViT's split
path (``block_kernel=False``: at the bfloat16 preset the attention kernels
and the MLP reverse kernel per block instead of the megakernels).
``--method`` names a method of the model's ``METHODS`` (ViT's
``explain/generator.py`` or BERT's ``explain/bert_generator.py``; default
``transformer_attribution``; BERT's ``rollout`` from start layer 0, as
``BertExplainer.generate_rollout`` calls it). ``--tp`` profiles the
tensor-parallel ViT program (``parallel.tensor.make_tp_explain_fn``) at
k = 1 over a single-rank NCCL process group instead of the single-device
path.
``--b2`` … ``--b10b`` profile one call of a layer kernel alone (B2, B3, B6,
B10a, B10b and the attention kernels B4, B5 at the ViT model's shapes, B=8;
B7, B8, B9 at
BERT-base B=8 and length ``--seq``; see ``layer_call``), each in the
preset's modes (B5 at ``float32``: exact FP32; ``production``: the
tensor-parallel production preset's float32 gradient and bf16 rule
products; ``bfloat16``: the split path's), and print every launch the call
makes (the attention passes, B5's row pass, column pass and head mean,
each GEMM-core instance, the LayerNorm, add-rule and other row kernels)
with its device time per call, and the GEMM core's share; the core's fused
passes, grouped launches and products on bf16 A rows (B10a, B10b) are
tagged.

Runs the kernel path (and, for comparison, the plain path) under
``torch.profiler`` after a warm-up, and prints: the wall time per batch, the
device busy share (sum of kernel times over the wall time of the window;
one stream, so kernels do not overlap), the kernels launched per batch and
the collectives' calls and host time per batch, the rollout B1's launches
and device time per batch, and the device time by
group (cuBLAS/CUTLASS GEMMs, the port's own kernels, NCCL, other PyTorch
kernels) and by kernel name. Writes a Chrome trace per path under ``--out`` (default
``build/profiles``, git-ignored). Random weights
from a seeded generator; needs no JAX.
"""

import argparse
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def group(name: str) -> str:
    low = name.lower()
    if "te::gemm_kernel" in name:
        return "port GEMM core (tensor cores)"
    if "te::" in name or name.startswith(("attn_", "rollout_", "head_mean",
                                           "blk_", "gemm_", "ln_", "add_",
                                           "bert_", "bias_add", "mask_")):
        return "port kernels"
    if "nccl" in low:
        return "NCCL collectives"
    if "gemm" in low or "cutlass" in low or "sm90_xmma" in low:
        return "GEMM (cuBLAS)"
    return "other PyTorch kernels"


def profile(fn, batches: int, trace: str):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    by_name, by_group = defaultdict(float), defaultdict(float)
    host = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            # host side: the collectives' calls and their CPU time
            if "allreduce" in evt.key.lower():
                host["all_reduce calls"] += evt.count / batches
                host["all_reduce host ms"] += (evt.cpu_time_total / 1e3
                                               / batches)
            continue
        # kernel events only: the CPU-side aten ops also carry the device
        # time of the kernels they launched
        dt = evt.self_device_time_total
        by_name[evt.key] += dt
        by_group[group(evt.key)] += dt
        host["kernels launched"] += evt.count / batches
        if "rollout" in evt.key:
            host["B1 launches"] += evt.count / batches
            host["B1 device ms"] += dt / 1e3 / batches
    return wall, by_name, by_group, host


def vit_config(model: str):
    """The ViT configuration of ``--model`` (ViT-B/16 for ``bert``, whose
    layer kernels do not read it)."""
    from transformer_explainability_torch.models import vit
    return {"vit_384": vit.ViTConfig(img_size=384),
            "vit_large": vit.VIT_LARGE_16_224,
            "deit_distilled": vit.DEIT_BASE_DISTILLED_16_224}.get(
                model, vit.VIT_BASE_16_224)


def vit_case(dev, cfg, prec):
    """(label, explain) of the ViT ``cfg`` at B=8, kernel and plain paths;
    ``prec`` holds explain_batch's precision, method and branch keywords."""
    from transformer_explainability_torch.explain.generator import (
        explain_batch)
    from transformer_explainability_torch.models.vit import (
        VisionTransformer, init_params)
    from transformer_explainability_torch.ops import kernels as K
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    model = VisionTransformer(cfg, device=dev)
    model.load_state_dict(params)
    model.requires_grad_(False)
    imgs, idx = vit_inputs(dev, cfg.img_size)
    return [(label, lambda ops=ops: explain_batch(model, imgs, idx, ops=ops,
                                                  **prec))
            for label, ops in (("kernel", K.KERNEL_OPS),
                               ("plain", K.PLAIN_OPS))]


def vit_inputs(dev, size=224):
    gen = torch.Generator(device=dev).manual_seed(1)
    imgs = torch.randn(8, 3, size, size, generator=gen, device=dev)
    return imgs, torch.full((8,), -1, dtype=torch.int64, device=dev)


def tp_case(dev, cfg, prec):
    """(label, explain) of the tensor-parallel program of the ViT ``cfg``
    at B=8 and k = 1 over a single-rank NCCL group (initialised here)."""
    import torch.distributed as dist
    from transformer_explainability_torch.models.vit import init_params
    from transformer_explainability_torch.ops import kernels as K
    from transformer_explainability_torch.ops.precision import mxu_name
    from transformer_explainability_torch.parallel import (
        make_tp_explain_fn, shard_tp_params)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    sh = shard_tp_params(params, cfg, mode=mxu_name(
        prec.get("matmul_precision")))
    imgs, idx = vit_inputs(dev, cfg.img_size)
    out = []
    for label, ops in (("kernel", K.KERNEL_OPS), ("plain", K.PLAIN_OPS)):
        fn = make_tp_explain_fn(cfg, pre_sharded=True, ops=ops, **prec)
        out.append((label, lambda fn=fn: fn(sh, imgs, idx)))
    return out


def bert_case(dev, S, prec):
    """(label, explain) of BERT-base at B=8, length S, each sample padded
    to its own length, kernel and plain paths; ``prec`` holds
    explain_batch's precision and method keywords."""
    from transformer_explainability_torch.explain.bert_generator import (
        explain_batch)
    from transformer_explainability_torch.models.bert import (
        BERT_BASE_UNCASED as cfg, BertForSequenceClassification, init_params)
    from transformer_explainability_torch.ops import kernels as K
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    model = BertForSequenceClassification(cfg, device=dev)
    model.load_state_dict(params)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(1)
    lengths = torch.randint(S // 8, S + 1, (8,), generator=gen, device=dev)
    lengths[0] = S
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).float()
    ids = torch.randint(1000, cfg.vocab_size, (8, S), generator=gen,
                        device=dev) * mask.long()
    idx = torch.full((8,), -1, dtype=torch.int64, device=dev)
    return [(label, lambda ops=ops: explain_batch(model, ids, mask, idx,
                                                  ops=ops, **prec))
            for label, ops in (("kernel", K.BERT_KERNEL_OPS),
                               ("plain", K.BERT_PLAIN_OPS))]


LAYER_KERNELS = ("b2", "b3", "b4", "b5", "b6", "b7", "b8", "b9", "b10a",
                 "b10b")


def layer_call(which, dev, S, prec, vcfg):
    """``(label, call)``: one call of the layer kernel ``which`` in the
    preset's modes, on random inputs from a seeded generator: at the ViT
    config ``vcfg``'s shapes, B=8, B4 ``attn_fwd_core`` and B5 ``attn_rev_core`` (q, k, v offset by
    1, as ``chip_smoke.py`` draws them), B2 ``block_fwd_core``, B3
    ``block_rev_core`` (from B2's anchors),
    B6 ``mlp_rev_core`` and the tensor-parallel MLP phases B10a / B10b at
    k = 1; at BERT-base, B=8, length S (the samples' masks cut at lengths
    S … S/8), B7 ``bert_layer_fwd_core``, B8 ``bert_out_rev_core`` and B9
    ``bert_attn_rev_core`` (from B7's anchors)."""
    from transformer_explainability_torch.models.bert import (
        BERT_BASE_UNCASED as bcfg)
    from transformer_explainability_torch.ops import bert_math as bmath
    from transformer_explainability_torch.ops import block_math as bm
    from transformer_explainability_torch.ops import kernels as K
    from transformer_explainability_torch.ops import precision as P
    from transformer_explainability_torch.ops.precision import mxu_name
    gen = torch.Generator(device=dev).manual_seed(2)
    mxu = mxu_name(prec.get("matmul_precision"))
    attn = mxu_name(prec.get("attn_precision", prec.get("matmul_precision")))
    rule = mxu_name(prec.get("relprop_precision",
                             prec.get("matmul_precision")))
    mlp = mxu_name(prec.get("mlp_precision", prec.get("matmul_precision")))
    mlp = mlp or mxu
    modes = f"modes mxu {mxu}, attn {attn}, rule {rule}, mlp {mlp}"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    vit = which in ("b2", "b3", "b4", "b5", "b6", "b10a", "b10b")
    cfg = vcfg if vit else bcfg
    vname = (f"ViT D={vcfg.embed_dim} h={vcfg.num_heads} "
             f"M={vcfg.mlp_dim}")
    D, h, hd = cfg.num_heads * cfg.head_dim, cfg.num_heads, cfg.head_dim
    if which in ("b4", "b5"):
        n = vcfg.num_tokens
        qkv, g_o, cam_o = randn(8, n, 3 * D) + 1.0, randn(8, n, D), randn(
            8, n, D)
        where = f"{vname} B=8 n={n} (modes attn {attn}, rule {rule})"
        if which == "b4":
            return (f"attn_fwd_core {where}",
                    lambda: K.attn_fwd_core(qkv, h, hd, hd ** -0.5, attn))
        return (f"attn_rev_core {where}",
                lambda: K.attn_rev_core(qkv, g_o, cam_o, h, hd, hd ** -0.5,
                                        attn, rule))
    inter = vcfg.mlp_dim if vit else bcfg.intermediate_size
    ws = [P.prepare_weight(randn(o, i).double() / i ** 0.5, mxu)
          for o, i in ((3 * D, D), (D, D), (inter, D), (D, inter))]
    vecs = [1.0 + 0.1 * randn(D), 0.1 * randn(D), 1.0 + 0.1 * randn(D),
            0.1 * randn(D), 0.1 * randn(3 * D), 0.1 * randn(D),
            0.1 * randn(inter), 0.1 * randn(D)]
    if vit:
        n, eps = vcfg.num_tokens, vcfg.block_ln_eps
        where = f"{vname} B=8 n={n} ({modes})"
        p = bm.BlockParams(*vecs, *ws)
        x, g, R = randn(8, n, D) + 0.5, randn(8, n, D), randn(8, n, D)
        fwd = K.block_fwd_core(x, p, h, hd, eps, mxu, attn, mlp,
                               save_attn=True, save_mlp=True)
        if which == "b2":
            return (f"block_fwd_core {where}",
                    lambda: K.block_fwd_core(x, p, h, hd, eps, mxu, attn, mlp,
                                             save_attn=True, save_mlp=True))
        if which == "b3":
            args = (x, fwd[1], fwd[2], g, R, p, h, hd, eps, mxu, attn, rule,
                    mlp)
            return (f"block_rev_core {where}",
                    lambda: K.block_rev_core(*args, saved=fwd[3:]))
        if which == "b6":
            return (f"mlp_rev_core {where}",
                    lambda: K.mlp_rev_core(fwd[1], g, R, p, eps, mlp, rule))
        tp = (p.ln2s, p.ln2b, p.b1, p.w1, p.w2, eps)
        ph1 = K.mlp_rev_tp_phase1(fwd[1], g, *tp, mlp, rule)
        if which == "b10a":
            return (f"mlp_rev_tp_phase1 k=1 {where}",
                    lambda: K.mlp_rev_tp_phase1(fwd[1], g, *tp, mlp, rule))
        Sr = 1.0 / (1.0 + ph1[1].abs())
        return (f"mlp_rev_tp_phase2 k=1 {where}",
                lambda: K.mlp_rev_tp_phase2(fwd[1], Sr, ph1[0], *tp, rule))
    eps = bcfg.layer_norm_eps
    where = f"BERT-base B=8 S={S} ({modes})"
    p = bmath.BertLayerParams(*vecs, *ws)
    lengths = S - (S // 8) * torch.arange(8, device=dev)
    keep = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    mask = (1.0 - keep.float()) * bcfg.mask_value
    x, g, R = randn(8, S, D), randn(8, S, D), randn(8, S, D)
    fargs = (x, mask, p, h, hd, eps, mxu, attn, mlp)
    if which == "b7":
        return (f"bert_layer_fwd_core {where}",
                lambda: K.bert_layer_fwd_core(*fargs, save_attn=True))
    fwd = K.bert_layer_fwd_core(*fargs, save_attn=True)
    if which == "b8":
        return (f"bert_out_rev_core {where}",
                lambda: K.bert_out_rev_core(fwd[1], g, R, p, eps, mxu, rule,
                                            mlp))
    args = (x, g, R, mask, p, h, hd, eps, mxu, attn, rule)
    return (f"bert_attn_rev_core {where}",
            lambda: K.bert_attn_rev_core(*args, saved=fwd[2:]))


def kernel_launches(which, dev, S, prec, card, vcfg, calls=10):
    """Every kernel one call of the layer kernel ``which`` (see
    :func:`layer_call`) launches, with its device time per call, under
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    label, call = layer_call(which, dev, S, prec, vcfg)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    rows = [(evt.self_device_time_total / calls, evt.count / calls, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA]
    total = sum(r[0] for r in rows)
    gemm = sum(r[0] for r in rows if "gemm_kernel" in r[2])
    print(f"[{card}] {label}: {total / 1e3:.4f} ms of kernels per call, "
          f"{sum(r[1] for r in rows):.0f} launches; GEMM core "
          f"{gemm / 1e3:.4f} ms ({gemm / total:.1%})")
    for us, count, name in sorted(rows, key=lambda r: -r[0]):
        print(f"  {us / 1e3:9.4f} ms  x{count:.0f}  {launch_tag(name)}"
              f"{name[:200]}")


# the GEMM core's launches that are not one plain product (gemm.cuh): the
# tensor-parallel MLP kernels' fused passes and grouped launch, and products
# on bf16 A rows
def launch_tag(name: str) -> str:
    if "gemm_kernel" not in name:
        return ""
    if "GemmNone" not in name:
        return "[grouped launch] "
    for spec, tag in (("SpecTwoA", "two-operand pass"),
                      ("SpecDualAbsA", "dual pass, |A| second"),
                      ("SpecThree", "three-set pass")):
        if spec in name:
            return f"[{tag}] "
    return "[bf16 A] " if re.search(r"SpecStd<[^>]*true>", name) else ""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vit",
                    choices=["vit", "vit_384", "vit_large", "deit_distilled",
                             "bert"])
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "production", "bfloat16",
                             "tensorfloat32"])
    ap.add_argument("--no-block-kernel", action="store_true")
    ap.add_argument("--method", default="transformer_attribution")
    ap.add_argument("--tp", action="store_true")
    for which in LAYER_KERNELS:
        ap.add_argument(f"--{which}", action="store_true")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from transformer_explainability_torch.explain.generator import (
        precision_kwargs)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    prec = precision_kwargs(args.precision)
    vcfg = vit_config(args.model)
    layer = [w for w in LAYER_KERNELS if getattr(args, w)]
    for which in layer:
        kernel_launches(which, dev, args.seq, prec, card, vcfg)
    if layer:
        return
    if args.model == "bert":
        kw = dict(prec, method=args.method)
        if args.method == "rollout":
            kw["start_layer"] = 0
        paths, what = bert_case(dev, args.seq, kw), f"bert_s{args.seq}"
        if args.method != "transformer_attribution":
            what += "_" + args.method
    elif args.tp:
        paths, what = tp_case(dev, vcfg, prec), f"{args.model}_tp1"
    else:
        kw = dict(prec, method=args.method,
                  block_kernel=not args.no_block_kernel)
        what = args.model + ("_split" if args.no_block_kernel else "")
        if args.method != "transformer_attribution":
            what += "_" + args.method
        paths = vit_case(dev, vcfg, kw)
    os.makedirs(args.out, exist_ok=True)
    for label, explain in paths:
        wall, by_name, by_group, host = profile(
            explain, args.batches, os.path.join(
                args.out, f"trace_{what}_{args.precision}_{label}.json"))
        busy = sum(by_name.values()) / 1e6
        per = wall / args.batches
        print(f"[{card}] {what} {args.precision} {label} path: "
              f"{per * 1e3:.2f} ms/batch of 8 under "
              f"the profiler, device busy {busy / wall:.1%}")
        print("  per batch: " + ", ".join(
            f"{k} {v:.4f}" if k == "B1 device ms" else f"{k} {v:.1f}"
            for k, v in sorted(host.items())))
        for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"  {g:24s} {us / 1e3 / args.batches:9.3f} ms/batch "
                  f"({us / 1e6 / busy:.1%} of device time)")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
            print(f"    {us / 1e3 / args.batches:9.3f} ms  {name[:100]}")
    if args.tp:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
