"""Build a CUDA source of ``csrc/`` with ``nvcc`` at first use and load it.

Each kernel source has a plain C entry point, so it is compiled on its own
into a shared library under ``build/kernels/`` of the checkout and bound
through ``ctypes`` (pointers from ``data_ptr()``, PyTorch's current stream).
The library's name carries a hash of the source, the headers of ``csrc/``
it may include and the flags: an edited source or header is rebuilt, a
stale library is never loaded.  Nothing is built when
a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


class LaunchCounter:
    """Number of times a wrapper launched its kernel (not the plain
    version); a run resets it and reads it back to show it went through
    the kernel."""

    def __init__(self):
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


class Library:
    """One ``csrc/`` source, built at first use and loaded once.
    ``declare`` sets ``argtypes``/``restype`` of the loaded entry points."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def build(self, verbose: bool = False) -> Path:
        """Compile unless already built; returns the library's path.
        ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
        out = self.path()
        if out.exists() and not verbose:
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}",
               *(("-Xptxas", "-v") if verbose else ()), "-o", tmp,
               str(self.source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            if verbose:
                print(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def load(self) -> ctypes.CDLL:
        """Build (first use) and load the library."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
        return self._lib
