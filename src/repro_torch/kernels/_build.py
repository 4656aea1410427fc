"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and compiles with ``nvcc``
into its own shared library for ``sm_90a``, loaded with ``ctypes``.  No
PyTorch headers are involved, so a build takes seconds.  Libraries land in
``_build/`` beside this file (listed in ``.gitignore``), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  :func:`build` starts one ``nvcc`` per missing library, all at once.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: library name → source file under csrc/
SOURCES = {
    "qrlora_bgmv": "qrlora_bgmv.cu",
    "paged_attention": "paged_attention.cu",
    "qrlora_matmul": "qrlora_matmul.cu",
    "flash_attention": "flash_attention.cu",
    "decode_attention": "decode_attention.cu",
}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, of every header
    under ``csrc/`` (a source may include any of them) and of the flags."""
    src = (_CSRC / SOURCES[name]).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None, verbose: bool = False) -> Dict[str, str]:
    """Compile the libraries that are missing, one ``nvcc`` each, in
    parallel; returns name → compiler output (``ptxas -v`` register and
    shared-memory report when ``verbose``).  Raises if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
