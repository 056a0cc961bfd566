"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/<name>-<hash>.so csrc/<name>.cu

into ``sat_tpu_torch/build/``, named by a hash of the sources and flags, and
loaded with ``ctypes``.  Each library exports an entry ``sat_<name>`` and
its launch plan ``sat_<name>_plan`` and its products' tiles
``sat_<name>_tiles``, whose C signatures ``ARGTYPES`` declares:
the wrappers pass ``data_ptr()`` values and the current stream as pointers.
Every entry returns a ``cudaError_t`` and ``check`` raises on a nonzero
code."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("decoder_step", "greedy_loop")
# -Xptxas=-v: the compiler output reports each kernel's registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C signature of each function that csrc/<name>.cu exports
ARGTYPES = {
    "decoder_step": {
        # dtype; embed, h, c, annot, att_enc, w1, wx, wo, wf, bb, bias, xt,
        # yt, g1, part, sc, t, h', c', z, alpha; B, Bp, L, D, A, H, E, N1, G,
        # Ep, K4, kc, splits, deep, k; stream
        "sat_decoder_step": [_I] + [_P] * 21 + [_I] * 15 + [_P],
        # dtype, B, k, L, D, H, E, N1, G, Ep, splits; out (42 ints)
        "sat_decoder_step_plan": [_I] * 11 + [ctypes.POINTER(_I)],
        # dtype; out (15 ints)
        "sat_decoder_step_tiles": [_I, ctypes.POINTER(_I)],
    },
    "greedy_loop": {
        # dtype; annot, att_enc, w1, wx, wo, wf, bb, bias, emb, wout, bout,
        # xt, yt, c, g1, part, tt, vpart, done, sc, tokens, alphas, scores,
        # flen, fin; B, Bp, L, D, A, H, E, V, S, N1, G, Ep, K4, kc, splits,
        # deep, VT; temperature; start, end, pad, unk; stream
        "sat_greedy_loop": [_I] + [_P] * 25 + [_I] * 17 + [_F] + [_I] * 4 + [_P],
        # dtype, B, L, D, E, V, N1, G, Ep, splits; out (48 ints)
        "sat_greedy_loop_plan": [_I] * 10 + [ctypes.POINTER(_I)],
        # dtype; out (20 ints)
        "sat_greedy_loop_tiles": [_I, ctypes.POINTER(_I)],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built with nvcc at first use")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, all nvcc processes at once.  Returns
    each compiled source's compiler output (the ``-Xptxas=-v`` report);
    raises with the compiler's output if one fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.sat_error_string.restype = ctypes.c_char_p
        lib.sat_error_string.argtypes = [_I]
        for sym, argtypes in ARGTYPES[name].items():
            entry = getattr(lib, sym)
            entry.restype = _I
            entry.argtypes = argtypes
        _libs[name] = lib
    return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sat_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

