"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file compiles, at first use, into its own shared library
under ``build/`` (listed in ``.gitignore``) with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<name>.so csrc/<name>.cu

All sources compile in parallel, one ``nvcc`` process each. No fast-math:
the fused decode kernel's int8 and fp8 ring writes must round exactly as
``cache._quantize_ring`` does. A library is rebuilt when a source in
``csrc/`` is newer than it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (sm_90a)")


def _stale(src: Path, lib: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return lib.stat().st_mtime < max(newest, src.stat().st_mtime)


def build_all(force: bool = False) -> Dict[str, object]:
    """Compile every stale source in parallel. Returns {"seconds", "logs"},
    where logs maps each built source to nvcc's output (register and shared
    memory use from ``-Xptxas -v``). Raises if any compile fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = BUILD / f"{src.stem}.so"
        if force or _stale(src, lib):
            tmp = BUILD / f"{src.stem}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src.stem] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                lib,
            )
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(BUILD / f"{name}.so"))
        _LIBS[name] = lib
    return lib
