"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a
plain C interface, which `ctypes` loads.  Libraries go to
`build/sin3dm_tpu_torch/` at the root of the checkout, named by a hash of
the source, every shared header `csrc/*.cuh` and the flags, so an edited
source or header builds anew.  Nothing but
the repository's own sources goes in.  Several sources build in parallel
through `build`.
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sin3dm_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build only "
                       "where the CUDA toolkit is installed")


def target(name: str, csrc: Path = None) -> Path:
    """Where the library of `<csrc>/<name>.cu` goes: a hash of that source,
    of every header in `csrc` (by name and content) and of the flags."""
    csrc = CSRC if csrc is None else csrc
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for hdr in sorted(csrc.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every missing library of `names`, one nvcc per source, all
    started together.  Returns {name: {"path", "seconds", "log"}} with the
    compiler's output (ptxas register/shared-memory report) in "log";
    raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = target(name)
        if so.exists():
            out[name] = {"path": str(so), "seconds": 0.0,
                         "log": (so.with_suffix(".log").read_text()
                                 if so.with_suffix(".log").exists() else "")}
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so, tmp)
    errors = []
    for name, (proc, so, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
        out[name] = {"path": str(so),
                     "seconds": time.perf_counter() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = target(name)
            if not so.exists():
                build([name])
            lib = ctypes.CDLL(str(so))
            _libs[name] = lib
        return lib
