"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
with a plain C interface under ``build/repro_torch/`` at the repository
root::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited source
rebuilds and a stale library is never loaded.  A build writes to a temporary
name and renames it into place, so concurrent processes never load half a
library.  ``torch.utils.cpp_extension`` is not used: it needs ``ninja`` and
compiles PyTorch's headers, minutes per file against seconds here.

Nothing here runs at import: the CPU tests import every module on a machine
with no ``nvcc``."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry points of each library, with their argument types
SIGNATURES: Dict[str, Dict[str, list]] = {
    "range_scan": {
        # path, x, dtype, scale, starts, lens, q, live, partial, arrivals,
        # out_ids, out_d, n_pad, d_pad, Q, w, k, n_valid, R, S, stream
        "range_scan_launch": [_I, _P, _I] + [_P] * 9 + [_I] * 8 + [_P],
    },
    "gather_dist": {
        # x, dtype, scale, ids, q, out, N, d, Q, M, stream
        "gather_dist_launch": [_P, _I] + [_P] * 4 + [_I] * 4 + [_P],
        # x, dtype, scale, ids, q, out_ids, out_d, N, d, Q, M, k, P, SZ,
        # stream
        "gather_topk_launch": [_P, _I] + [_P] * 5 + [_I] * 7 + [_P],
        # path, vec, x, ids, q, out_ids, out_d, scratch, arrivals, N, d, Q,
        # M, k, R, S, P, SZ, stream
        "gather_rerank_launch": [_I, _I] + [_P] * 7 + [_I] * 9 + [_P],
    },
    "l2dist": {
        # q, x, dtype, out, Q, N, d, stream
        "l2dist_launch": [_P, _P, _I, _P] + [_I] * 3 + [_P],
    },
    "beam": {
        # x, dtype, scale, nbrs, q, lo, hi, seeds, init_d, init_id, init_e,
        # out_d, out_id, out_steps, out_ndist, visited, pool, trace, Q, d,
        # m, E, ef, B, H, W, steps_cap, early_stop, pool_global, R, layout,
        # stream
        "beam_single_launch": [_P, _I] + [_P] * 16 + [_I] * 12 + [_P] * 2,
        "beam_batched_launch": [_P, _I] + [_P] * 16 + [_I] * 12 + [_P] * 2,
    },
}

#: element types the kernels take, by their code in ``csrc/corpus.cuh``
#: (``l2dist`` takes float32 and bfloat16)
DTYPE_CODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: serializes first loads: the serving engine's dispatch thread and a
#: compaction or test thread may reach an unbuilt library at once, and two
#: builds in one process would share one temporary file name
_LIB_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels "
                           "build with the CUDA toolkit's nvcc")
    return path


def _sources(name: str) -> List[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def target(name: str) -> Path:
    """Library path for the current sources and flags of one kernel file."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None, *, verbose: bool = False) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns each built library's compiler log (with ``verbose``,
    ``-Xptxas -v``'s registers, shared memory and spills per kernel).
    Raises ``RuntimeError`` with the compiler's output if a build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        out = target(name)
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            if tmp.exists():
                tmp.unlink()
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel file, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LIB_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(target(name)))
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _LIBS[name] = lib
    return lib


def corpus_operands(x: torch.Tensor, scale, what: str):
    """A corpus and its optional per-dimension scale as a kernel takes
    them: (x contiguous, its dtype code, scale as contiguous (d,) f32 on
    x's device or None).  Raises on a dtype no kernel takes."""
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"{what}: corpus dtype {x.dtype} is not float32, "
                         f"int8 or bfloat16")
    if scale is not None:
        scale = scale.to(device=x.device, dtype=torch.float32)
        scale = scale.reshape(-1).contiguous()
        if scale.numel() != x.shape[1]:
            raise ValueError(f"{what}: scale has {scale.numel()} entries, "
                             f"x has {x.shape[1]} columns")
    return x.contiguous(), code, scale


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launcher."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
