"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  It is
compiled for sm_90a with ``nvcc`` into ``build/kernels/lib<name>.so`` at
first use and loaded with ``ctypes``; a library older than its source, or
built with other flags, is rebuilt.  :func:`start` launches ``nvcc``
without waiting, so a caller can build several kernels at once and collect
them with :meth:`Build.wait`.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _flags_path(library: Path) -> Path:
    """The flags a library was built with, beside it."""
    return library.with_suffix(".flags")


class Build:
    """One ``nvcc`` run in flight; :meth:`wait` raises if it failed."""

    def __init__(self, name: str, flags: tuple[str, ...], verbose: bool):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        self.library = library_path(name)
        self.library.parent.mkdir(parents=True, exist_ok=True)
        self._tmp = self.library.with_name(
            f"{self.library.name}.{os.getpid()}.tmp")
        self._flags = flags
        cmd = [nvcc, *_BASE_FLAGS, *flags]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(self._tmp), str(CSRC / f"{name}.cu")]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)

    def wait(self) -> str:
        """Wait for ``nvcc``; install the library and return the compiler's
        diagnostics (``-Xptxas -v`` output when built verbose)."""
        _, err = self._proc.communicate()
        if self._proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({self._proc.returncode}):\n{err}")
        os.replace(self._tmp, self.library)
        _flags_path(self.library).write_text(" ".join(self._flags))
        return err


def start(name: str, flags: tuple[str, ...] = (),
          verbose: bool = False) -> Build:
    """Start compiling ``csrc/<name>.cu`` with ``flags`` added to the base
    sm_90a flags."""
    return Build(name, flags, verbose)


def load(name: str, flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library, built first if missing, older than its
    source or built with other flags."""
    lib = library_path(name)
    src = CSRC / f"{name}.cu"
    stamp = _flags_path(lib)
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime or \
            not stamp.exists() or stamp.read_text() != " ".join(flags):
        start(name, flags).wait()
    return ctypes.CDLL(str(lib))


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
