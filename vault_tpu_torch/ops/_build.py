"""Builds the port's CUDA kernels from ``vault_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/vault_tpu_torch/
lib<name>-<hash>.so`` at the repository root, and is loaded with
``ctypes``.  The hash covers the sources and the flags, so an edited source
never loads a stale library.  All sources compile at once, one ``nvcc``
each.  Nothing here runs when a module is imported: the first kernel launch
(or :func:`build_all`) builds.  A failed build raises; nothing falls back.
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
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vault_tpu_torch"
SOURCES = ("adamw", "attention", "attention_bwd", "attention_gqa", "gemm_sm90", "linear_w8a8",
           "ln_qkv", "mlp", "mlp_bwd", "mlp_w8a8", "moe_experts", "swiglu_w8a8")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing, all in parallel.
    Returns, per source, the seconds its build took and what nvcc printed
    (ptxas register, shared-memory and spill lines); (0.0, "") for one
    already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, built, t0 = {}, {}, time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            built[name] = (0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        built[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def load(name: str, signatures: Dict[str, Tuple[Sequence, type]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first call.
    ``signatures`` maps each C function to its ctypes (argtypes, restype)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all(SOURCES)
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            lib.vt_error_string.argtypes = [ctypes.c_int]
            lib.vt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a launch's CUDA error code."""
    if code != 0:
        msg = lib.vt_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} ({msg})")
