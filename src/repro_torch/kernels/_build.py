"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/repro_torch_kernels/lib<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists).  The hash covers the source and the flags, so
an edited source rebuilds and an unchanged one is loaded as built.  Nothing is
compiled at import: the first wrapper call on a CUDA tensor builds what it
needs, and ``build()`` builds every kernel at once, one ``nvcc`` per source,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("aggregate", "flash_attention", "fused_sgd", "ssd_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled from src/repro_torch/kernels/csrc "
        "at first use and need the CUDA toolkit")


def _target(name: str) -> Tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every library in ``names`` that is not built yet, in parallel.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) lands beside each library as ``<lib>.log``.  Raises with that
    output if any compile fails, after every started ``nvcc`` has ended."""
    jobs = []
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit "
                          f"{proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)       # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))


def build_log(name: str) -> str:
    """The compiler output of ``name``'s current build ('' if none)."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed.

    ``signatures`` maps each C function to ``(restype, argtypes)``; pointers
    and the stream are ``c_void_p`` so ctypes never cuts them to 32 bits."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _target(name)[1]
            if not so.exists():
                build((name,))
            lib = ctypes.CDLL(str(so))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
    return lib
