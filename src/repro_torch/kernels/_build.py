"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, ``build/repro_torch_kernels/
lib<name>-<hash>.so`` under the repository root (``build/`` is
git-ignored), at first use; the content hash of the source names the
library, so an edited source never loads a stale build.  ``load`` opens
it with ``ctypes``.  Nothing here runs at import time: a CPU-only process
never looks for ``nvcc``.

The C ABI and the exact ``nvcc`` line are documented at the top of each
source (``csrc/mixing.cu``).  ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them; ``chip_smoke.py`` calls it
before anything else so the build counts as set-up.
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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "library_path",
           "build_all", "load", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the repro_torch CUDA kernels "
            "are built from source at first use on a CUDA machine")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns ``(out_path, tmp_path, Popen)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return out, tmp, proc, log


def build_all(names: List[str] = None) -> List[Path]:
    """Compile every (or the named) ``csrc/*.cu`` in parallel, one
    ``nvcc`` each; raises with the compiler's log if any build fails.
    Returns the library paths."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        jobs = [(n, _start(n)) for n in names]
        for name, job in jobs:
            if job is None:
                continue
            out, tmp, proc, log = job
            rc = proc.wait()
            log.close()
            if rc != 0:
                text = out.with_suffix(".log").read_text()
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(exit {rc}):\n{text}")
            os.replace(tmp, out)     # atomic: concurrent builders agree
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``'s library, building it on
    first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[0]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error code."""
    if rc != 0:
        err = lib.repro_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({err(rc).decode()}) at launch")
