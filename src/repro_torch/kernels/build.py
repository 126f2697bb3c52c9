"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is compiled on
first use by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the root of the checkout, then loaded with ``ctypes``.
The library's file name carries a hash of its source, so an edited source is
rebuilt and a stale library is never loaded. Nothing is fetched and no binary
is committed: ``nvcc`` (the CUDA toolkit) must be on the machine that runs
the kernels.

``build_all`` starts one ``nvcc`` per source at once and waits for all of
them; a wrapper's first launch builds just its own source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_decode_attention", "flash_attention", "decode_attention", "rglru",
           "flash_attention_bwd", "rglru_bwd")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: ptxas report (registers, shared memory, spills) of each source built here
ptxas_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first use "
        "and need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` for the current sources lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    ptxas_log[name] = log
    out = lib_path(name)
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every listed source that has no up-to-date library yet, all
    ``nvcc`` processes running at once."""
    with _lock:
        procs = [(n, _start(n)) for n in names]
        for n, proc in procs:
            _finish(n, proc)


def ptxas_kernels(name: str) -> Dict[str, str]:
    """Each kernel variant of ``name`` built here (mangled name) with the
    registers and spill line ptxas reported for it."""
    out: Dict[str, str] = {}
    current = None
    for line in ptxas_log.get(name, "").splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line.strip()
        elif current and "spill" in line:
            out[current] = line.strip()
        elif current and "Used" in line and "registers" in line:
            out[current] = line.split(":", 1)[-1].strip() + "; " + out.get(current, "")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
