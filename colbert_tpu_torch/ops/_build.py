"""Build and load the port's native code: nvcc or g++ -> shared library -> ctypes.

Each ``csrc/<name>.cu`` compiles, with a plain C interface, into
``colbert_tpu_torch/_build/<name>-<hash>.so`` at first use.  The hash covers
the sources' contents and the flags, never their modification times: a
checkout sets mtimes arbitrarily, so an mtime rule can load a stale library.
:func:`load_libraries` starts one nvcc per missing library, all at once.
The host runtime, ``csrc/<name>.cpp``, builds the same way with g++
(:func:`load_host_library`); its hash also covers the compiler's version.
A failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: g++ flags of the host runtime: a baseline ISA, so that the library runs on
#: any x86-64 host (these loops are bound by memcpy, not by vector width)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()
_host_libs: Dict[Path, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library built here
build_logs: Dict[str, str] = {}


class LaunchCounter:
    """Thread-safe count of one kernel's launches (the serve path is threaded)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _source_hash(src: Path) -> str:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_libraries(*names: str) -> List[ctypes.CDLL]:
    """Compile each ``csrc/<name>.cu`` whose content hash has no library yet,
    one nvcc process per source, all started together; then load them all."""
    with _lock:
        todo = {}
        for name in names:
            if name in _libs:
                continue
            src = CSRC / f"{name}.cu"
            so = BUILD_DIR / f"{name}-{_source_hash(src)}.so"
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
                todo[name] = (src, so, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            else:
                _libs[name] = ctypes.CDLL(str(so))
        failed = []
        for name, (src, so, tmp, proc) in todo.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed with code {proc.returncode} building {src.name}:\n{err}")
                continue
            build_logs[name] = err
            os.replace(tmp, so)  # atomic: a concurrent process sees all or nothing
            _libs[name] = ctypes.CDLL(str(so))
        if failed:
            raise RuntimeError("\n".join(failed))
        return [_libs[n] for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its content hash has no library yet, then load it."""
    return load_libraries(name)[0]


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's host runtime (csrc/*.cpp) builds with g++")
    return found


def load_host_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cpp`` with g++ if its content hash (the source,
    the flags and the compiler's version line) has no library yet, then load
    it.  Processes and threads may build at once: each writes its own
    temporary file and renames it into place."""
    gxx = _gxx()
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True)
    if version.returncode != 0:
        raise RuntimeError(f"{gxx} --version failed with code {version.returncode}:\n{version.stderr}")
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update((version.stdout.splitlines() or [""])[0].encode())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    with _host_lock:
        lib = _host_libs.get(so)
        if lib is not None:
            return lib
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed with code {proc.returncode} building {src.name}:\n{proc.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent process sees all or nothing
        lib = _host_libs[so] = ctypes.CDLL(str(so))
        return lib
