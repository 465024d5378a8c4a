"""Where B5's row pass (``csrc/attn_rev.cu``) spends its device time.

    python3 experiments/torch_b5_phases.py

Builds three variants of ``attn_rev.cu`` beside ``rollout.cu`` (which holds
``te_error_string``) into small libraries under ``build/b5_phases/``: one
whose row pass returns after the forward recompute (B4's tile: scores,
softmax, P·V and S1), one that returns after the V sweep as well, and the
whole pass. Each is timed under ``torch.profiler`` (the row-pass launch's
device time, 20 calls after warm-up) at ViT-B/16 B=8 in exact FP32, in the
tensor-parallel production preset's modes and in the split path's, so the
differences give each phase's share. The variants' results are not used.
Needs a CUDA card and ``nvcc``; imports no JAX.
"""

import ctypes
import os
import shutil
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "transformer_explainability_torch", "csrc")
OUT = os.path.join(ROOT, "build", "b5_phases")
NVCC = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
# where the variants return: before the V sweep, before the K sweep
STOPS = {"forward recompute": "  if constexpr (RA && !RR) {\n",
         "+ V sweep": "  __syncthreads();   // V is consumed\n"}


def build():
    src = open(os.path.join(CSRC, "attn_rev.cu")).read()
    texts = {label: src.replace(mark, "  return;\n" + mark, 1)
             for label, mark in STOPS.items()}
    texts["whole row pass"] = src
    procs = {}
    for i, (label, text) in enumerate(texts.items()):
        assert label == "whole row pass" or text != src, label
        d = os.path.join(OUT, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        with open(os.path.join(d, "attn_rev.cu"), "w") as f:
            f.write(text)
        procs[label] = (d, subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "attn_rev.cu"),
             os.path.join(d, "rollout.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")
        fn = ctypes.CDLL(os.path.join(d, "lib.so")).te_attn_rev_f32
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_double, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        libs[label] = fn
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build()
    B, n, H, hd = 8, 197, 12, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, n, 3 * H * hd, device="cuda", generator=g) + 1.0
    g_o, cam_o = (torch.randn(B, n, H * hd, device="cuda", generator=g)
                  for _ in range(2))
    outs = [torch.empty_like(qkv), torch.empty_like(qkv),
            torch.empty(B, n, n, device="cuda")]
    maps = [torch.empty(B, H, n, n, device="cuda") for _ in range(4)]
    S1 = torch.empty(B, H, n, hd, device="cuda")
    ptrs = [t.data_ptr() for t in (qkv, g_o, cam_o, *outs, *maps, S1)]
    modes = {"exact FP32": (0, 0), "TP production": (0, 1),
             "split path": (1, 1)}
    for mode, (attn, rule) in modes.items():
        for label, fn in libs.items():
            stream = torch.cuda.current_stream().cuda_stream
            call = lambda: fn(*ptrs, B, n, H, hd, hd ** -0.5, attn, rule,
                              stream)
            for _ in range(3):
                assert call() == 0
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            ms = sum(e.self_device_time_total / 20 / 1e3
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and "attn_rev_rows_kernel" in e.key)
            print(f"[{card}] B5 {mode} modes, ViT-B/16 B=8: row pass up to "
                  f"{label}: {ms:.4f} ms")


if __name__ == "__main__":
    main()
