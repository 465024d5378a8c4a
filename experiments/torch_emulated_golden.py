"""Write the emulated kernels' outputs in the modes that predate bf16×3
(``tests/torch_emulator_common.py: mode_outputs``) from a checkout's CUDA
sources, built against that checkout's thread-level emulator with g++.

    python3 experiments/torch_emulated_golden.py --root <checkout> \
        --out tests/golden/torch_emulated_modes.npz

``<checkout>`` is a copy of the commit whose outputs are to be kept (for
this file: the one before the kernels gained their bf16×3 modes, unpacked
with ``git archive``). The inputs and the calls are this repository's
(``mode_outputs``); the C entries' arguments are the same in both. Needs
no card; takes about a minute and a half to build.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from transformer_explainability_torch.ops import _build  # noqa: E402
from torch_emulator_common import mode_outputs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    csrc = os.path.join(args.root, "transformer_explainability_torch", "csrc")
    emu = os.path.join(args.root, "tests", "cuda_emulator")
    sources = sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                     if f.endswith(".cu"))
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libte_emulated.so")
        subprocess.run(["g++", "-std=c++20", "-O1", "-fno-strict-aliasing",
                        "-shared", "-fPIC", "-pthread", "-I", emu, "-o", so,
                        os.path.join(emu, "shared_memory.cpp"), "-x", "c++",
                        *sources], check=True)
        outs = mode_outputs(_build.declare(ctypes.CDLL(so)))
    np.savez_compressed(args.out, **outs)
    print(f"{args.out}: {len(outs)} arrays")


if __name__ == "__main__":
    main()
