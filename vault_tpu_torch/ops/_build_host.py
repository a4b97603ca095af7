"""Builds the port's host libraries from ``vault_tpu_torch/csrc/host`` at
first use: the WordPiece core (``wordpiece.cpp``, text/native.py) and the
PIL-exact bicubic resize (``imagecore.cpp``, data/native_image.py).

Each source compiles with the host C++ compiler (``$CXX``, else ``g++``)
and the flags of the JAX package's ``native/Makefile`` into
``build/vault_tpu_torch/lib<name>-<hash>.so`` at the repository root, and
is loaded with ``ctypes``.  The hash covers the source, the compiler and
the flags; for ``-march=native`` also the processor the compiler resolves
it to, so a library built on another machine's processor is never loaded.
Several processes may build at once (``pytest -n``): each build holds a
file lock, compiles to a temporary file and renames it into place, so
every process loads one whole library.  A failed build raises and names
the compiler; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

from vault_tpu_torch.ops._build import BUILD_DIR

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
COMMON_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
FLAGS = {"wordpiece": COMMON_FLAGS,
         "imagecore": COMMON_FLAGS + ("-march=native", "-funroll-loops")}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    name = os.environ.get("CXX") or "g++"
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"host C++ compiler {name!r} not found (set CXX): the "
                           "port's host libraries are built from source at first use")
    return path


@functools.lru_cache(maxsize=None)
def _native_target(compiler: str) -> str:
    """What ``-march=native`` means to ``compiler`` on this machine."""
    out = subprocess.run([compiler, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True).stdout
    return " ".join(ln.split()[-1] for ln in out.splitlines()
                    if ln.strip().startswith(("-march=", "-mtune=")))


def lib_path(name: str) -> Path:
    compiler = cxx()
    h = hashlib.sha256((HOST_SRC / f"{name}.cpp").read_bytes())
    h.update(" ".join((compiler, *FLAGS[name])).encode())
    if "-march=native" in FLAGS[name]:
        h.update(_native_target(compiler).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/host/<name>.cpp`` unless its library exists; returns
    the library's path."""
    out = lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx(), *FLAGS[name], "-o", str(tmp), str(HOST_SRC / f"{name}.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host library build failed: {' '.join(cmd)} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str, signatures: Dict[str, Tuple[Sequence, type]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/host/<name>.cpp``, built on first call.
    ``signatures`` maps each C function to its ctypes (argtypes, restype)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
