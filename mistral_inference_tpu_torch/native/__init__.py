"""ctypes binding of the C++ BPE merge loops (``bpe.cc``).

``lib()`` builds ``libbpe.so`` at first use with ``$CXX`` (``g++`` when it is
unset) and ``-O2 -std=c++17 -fPIC -Wall -shared`` into ``build/`` beside this
file, named after a hash of the source, and caches the handle. The library is
written under a temporary name and renamed into place, so concurrent
processes never load a half-written file. A failed build raises with the
compiler's output: callers that want the pure-Python merge loop ask for it by
name (``SentencePieceBPE(..., merge="python")``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).parent / "bpe.cc"
BUILD_DIR = Path(__file__).parent / "build"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_LIB: Optional[ctypes.CDLL] = None


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``bpe.cc`` unless this source's library is already in
    ``out_dir``; returns its path. Raises RuntimeError if the compiler fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = Path(out_dir) / f"libbpe-{digest}.so"
    if so.is_file():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    cxx = shlex.split(os.environ.get("CXX") or "g++")
    fd, tmp = tempfile.mkstemp(prefix=so.name + ".", dir=so.parent)
    os.close(fd)
    try:
        cmd = [*cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"native BPE build failed: {shlex.join(cmd)}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(
                f"native BPE build failed (exit {res.returncode}): {shlex.join(cmd)}\n"
                f"{res.stderr}{res.stdout}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    L = ctypes.CDLL(str(build()))
    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    L.spm_create.restype = ctypes.c_void_p
    L.spm_create.argtypes = [ctypes.c_char_p, i32p, f32p, ctypes.c_int32, ctypes.c_int32]
    L.spm_destroy.argtypes = [ctypes.c_void_p]
    L.spm_encode.restype = ctypes.c_int32
    L.spm_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, i32p]
    _LIB = L
    return L
