"""Where the rollout B1 (``csrc/rollout.cu``) spends its device time.

    python3 experiments/torch_b1_variants.py

Builds variants of ``rollout.cu`` (it holds ``te_error_string`` itself)
by its ``TE_B1_*`` switches into small libraries under
``build/b1_variants/``, each in its own ``nvcc``:

  as built       the kernel as it is;
  no FMAs        the tile's products skipped (``TE_B1_NO_FMAS``): the
                 ring's copies, the row sums and the per-tile and per-layer
                 bookkeeping;
  no copies      the tile's TMA copy skipped (``TE_B1_NO_COPIES``, its
                 barrier expects 0 bytes): the products on stale tiles, the
                 row sums, the bookkeeping;
  skeleton       neither;
  ring 2 / 4     the row form's ring in 2 or 4 stages of the same 200 KB
                 (``TE_B1_ROW_STAGES``);
  16 KB copies   each tile's body moved by TMA copies of 16 KB from one
                 thread instead of one copy (``TE_B1_COPY_BYTES``).

Each is timed under ``torch.profiler`` (the chain launch's device time, 30
calls after warm-up) at ViT-B/16 B=8 (n = 197, 12 layers, start 0): the row
form (``rows=1``) without and with row normalisation and the full form, and
the row form at n = 512; every variant in a process of its own. The
results of the variants that compute the product are held to a float64
chain on the card (``BAD`` marks a relative error above 1e-5). Needs a CUDA
card and ``nvcc``; imports no JAX.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "transformer_explainability_torch", "csrc")
OUT = os.path.join(ROOT, "build", "b1_variants")
NVCC = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
CASES = [(197, 0, 1), (197, 1, 1), (197, 0, 197), (512, 0, 1)]  # n, norm, rows
B, L = 8, 12

# label: (nvcc -D flags, whether the variant computes the product)
VARIANTS = {
    "as built": ((), True),
    "no FMAs": (("TE_B1_NO_FMAS",), False),
    "no copies": (("TE_B1_NO_COPIES",), False),
    "skeleton": (("TE_B1_NO_FMAS", "TE_B1_NO_COPIES"), False),
    "ring 2": (("TE_B1_ROW_STAGES=2",), True),
    "ring 4": (("TE_B1_ROW_STAGES=4",), True),
    "16 KB copies": (("TE_B1_COPY_BYTES=16384",), True),
}


def build():
    procs = {}
    for i, (label, (flags, _)) in enumerate(VARIANTS.items()):
        d = os.path.join(OUT, str(i))
        os.makedirs(d, exist_ok=True)
        procs[label] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared",
             *(f"-D{f}" for f in flags), "-o", os.path.join(d, "lib.so"),
             os.path.join(CSRC, "rollout.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for label, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")


def load(i):
    fn = ctypes.CDLL(os.path.join(OUT, str(i), "lib.so")).te_rollout_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


def device_ms(fn, iters=30):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def run_variant(i, label, checked):
    fn = load(i)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    cells = []
    for n, norm, rows in CASES:
        cams = torch.randn(B, L, n, n, device="cuda", generator=gen).abs()
        cams *= 1e-3
        out = torch.empty(B, rows, n, device="cuda")
        ms = device_ms(lambda: fn(cams.data_ptr(), None, out.data_ptr(),
                                  None, B, L, 0, n, 0, norm, rows, stream))
        cell = f"n={n} norm={norm} rows={rows} {ms:.4f} ms"
        if checked:
            m = cams.double() + torch.eye(n, device="cuda",
                                          dtype=torch.float64)
            if norm:
                m = m / m.sum(-1, keepdim=True)
            J = m[:, L - 1]
            for li in range(L - 2, -1, -1):
                J = J @ m[:, li]
            err = ((out.double() - J[:, :rows]).abs().max()
                   / J.abs().max()).item()
            cell += f" BAD {err:.1e}" if err > 1e-5 else ""
        cells.append(cell)
    print(f"{label:14s} " + "; ".join(cells), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    variants = list(VARIANTS.items())
    if len(sys.argv) > 1:      # one variant, in a process of its own
        i = int(sys.argv[1])
        run_variant(i, variants[i][0], variants[i][1][1])
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[{card}] B1 variants, ViT-B/16 B={B} L={L} start 0, device ms "
          f"per call (profiler)")
    build()
    for i, (label, _) in enumerate(variants):
        res = subprocess.run([sys.executable, __file__, str(i)],
                             capture_output=True, text=True)
        print(res.stdout.strip() if res.returncode == 0
              else f"{label:14s} failed: {res.stderr.strip()[-300:]}",
              flush=True)


if __name__ == "__main__":
    main()
