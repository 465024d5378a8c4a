"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface. At first use ``nvcc`` compiles each
``.cu`` into an object, all in parallel, and links them into one shared
library, keyed by a hash of the sources and flags, under ``build/kernels/``
of the checkout (listed in ``.gitignore``); ``ctypes`` loads it. Nothing here runs at import time, and building the command line
needs no CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libte_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def sources() -> List[Path]:
    """The ``.cu`` translation units, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return nvcc


def compile_commands(obj_dir: Path, nvcc: str = "nvcc") -> List[List[str]]:
    """One ``nvcc -c`` per source, each into ``obj_dir/<stem>.o``."""
    return [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj_dir / f"{src.stem}.o"),
             str(src)] for src in sources()]


def link_command(out: Path, objs: List[str], nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *ARCH, "-shared", "-o", str(out), *objs]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the library unless this version of the sources is built:
    every source at once in its own ``nvcc``, then one link. The
    compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside it as ``build.log``."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"tmp.{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    cmds = compile_commands(tmp, nvcc)
    # each compiler's output to a file of its own (no pipe to drain), its
    # time taken as it finishes
    logs = [open(tmp / f"nvcc.{i}.log", "w+") for i in range(len(cmds))]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for c, f in zip(cmds, logs)]
    secs = [None] * len(procs)
    while any(t is None for t in secs):
        for i, proc in enumerate(procs):
            if secs[i] is None and proc.poll() is not None:
                secs[i] = time.perf_counter() - t0
        time.sleep(0.1)
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    log = []
    for cmd, proc, out, sec in zip(cmds, procs, outs, secs):
        log.append(f"{' '.join(cmd)}\nseconds {sec:.1f}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    lib_tmp = tmp / LIB_NAME
    cmd = link_command(lib_tmp, [c[c.index("-o") + 1] for c in cmds], nvcc)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed with code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    (so.parent / "build.log").write_text(
        f"seconds {time.perf_counter() - t0:.1f}\n" + "\n".join(log))
    os.replace(lib_tmp, so)      # atomic: a concurrent build loses nothing
    shutil.rmtree(tmp, ignore_errors=True)
    return so


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set argtypes/restype of every entry point: each pointer and the
    stream are ``c_void_p`` (a plain ``int`` would be cut to 32 bits)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for dt in ("f32", "f64"):
        fwd = getattr(lib, f"te_attn_fwd_{dt}")
        fwd.argtypes = [P, P, I, I, I, I, F, I, P]
        fwd.restype = I
        rev = getattr(lib, f"te_attn_rev_{dt}")
        rev.argtypes = [P] * 11 + [I, I, I, I, F, I, I, P]
        rev.restype = I
        roll = getattr(lib, f"te_rollout_{dt}")
        roll.argtypes = [P] * 4 + [I] * 7 + [P]
        roll.restype = I
    lib.te_block_fwd_f32.argtypes = [P] * 28 + [I] * 5 + [F, I, I, I, P]
    lib.te_block_fwd_f32.restype = I
    lib.te_block_rev_f32.argtypes = [P] * 40 + [I] * 5 + [F] + [I] * 5 + [P]
    lib.te_block_rev_f32.restype = I
    lib.te_bert_fwd_f32.argtypes = [P] * 25 + [I] * 5 + [F] + [I] * 3 + [P]
    lib.te_bert_fwd_f32.restype = I
    lib.te_bert_out_rev_f32.argtypes = [P] * 31 + [I] * 4 + [F] + [I] * 2 + [P]
    lib.te_bert_out_rev_f32.restype = I
    lib.te_bert_attn_rev_f32.argtypes = [P] * 36 + [I] * 4 + [F] + [I] * 4 + [P]
    lib.te_bert_attn_rev_f32.restype = I
    lib.te_mlp_rev_tp1_f32.argtypes = [P] * 17 + [I] * 3 + [F, I, I, I, P]
    lib.te_mlp_rev_tp1_f32.restype = I
    lib.te_mlp_rev_tp2_f32.argtypes = [P] * 18 + [I] * 3 + [F, I, I, P]
    lib.te_mlp_rev_tp2_f32.restype = I
    lib.te_mlp_rev_f32.argtypes = [P] * 19 + [I] * 4 + [F, I, I, P]
    lib.te_mlp_rev_f32.restype = I
    lib.te_gemm_f32.argtypes = [P] * 7 + [I] * 11 + [P]
    lib.te_gemm_f32.restype = I
    lib.te_gemm_fused_f32.argtypes = [I, I] + [P] * 8 + [I] * 8 + [P]
    lib.te_gemm_fused_f32.restype = I
    lib.te_gemm_grid_cap.argtypes = [I]
    lib.te_gemm_grid_cap.restype = I
    lib.te_error_string.argtypes = [I]
    lib.te_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, once per process: the
    first call builds under a lock, so that two threads launching kernels
    (a server's) never build or load it twice."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = declare(ctypes.CDLL(str(build())))
    return _lib
