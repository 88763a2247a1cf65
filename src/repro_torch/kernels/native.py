"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``.

Sources live in ``repro_torch/csrc/``.  Each is compiled for ``sm_90a`` at
first use into ``repro_torch/_build/`` (listed in ``.gitignore``), under a
file name keyed on a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is reused.  :func:`build` starts one
``nvcc`` per source, all at once.  Nothing is built or imported when this
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def library_path(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}.so"


def build(srcs=None) -> dict[str, dict]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together.  Returns ``{stem: {"path", "seconds",
    "log"}}`` (``log`` holds ``-Xptxas -v``'s register and shared-memory
    report; ``seconds`` is 0 for a library that was already built).  Raises
    ``RuntimeError`` with the compiler output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in (sources() if srcs is None else [Path(s) for s in srcs]):
        lib = library_path(src)
        if lib.exists():
            out[src.stem] = {"path": str(lib), "seconds": 0.0, "log": ""}
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((src, lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, lib, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader never sees half
        out[src.stem] = {"path": str(lib), "seconds": secs, "log": log}
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return out


def load(stem: str) -> ctypes.CDLL:
    """Load the library built from ``csrc/<stem>.cu`` (built if needed);
    callers keep the handle."""
    return ctypes.CDLL(build([CSRC / f"{stem}.cu"])[stem]["path"])
