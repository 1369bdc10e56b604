"""Build and load the hand-written CUDA kernel families.

Every family keeps its kernels in ``csrc/*.cu`` files with a plain C
interface, one shared library a file (the headers a file includes named as
its ``deps``).  :class:`CudaLibrary` compiles one with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/lib<name>.so`` at first use — never
at import, so the CPU tests import every kernel module freely — and loads
it with :mod:`ctypes`.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

#: build output inside the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def stream() -> int:
    """PyTorch's current CUDA stream, as the ``void*`` the launchers take."""
    return torch.cuda.current_stream().cuda_stream


#: guards every launch counter: the serving frontend launches from many
#: threads, and ``table[key] += 1`` is a read-modify-write that would lose
#: counts between them
_COUNT_LOCK = threading.Lock()


def count_launch(table: Dict[str, int], key: str) -> None:
    """Add one to ``table[key]``, atomically."""
    with _COUNT_LOCK:
        table[key] += 1


def reset_counts(*tables: Dict[str, int]) -> None:
    """Zero every entry of the given launch-counter tables, atomically."""
    with _COUNT_LOCK:
        for table in tables:
            for k in table:
                table[k] = 0


def raise_on(err: int, kernel: str) -> None:
    """The C launchers return ``cudaGetLastError()`` after the launch."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


class CudaLibrary:
    """One ``.cu`` source, its shared library and its ctypes signatures.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the C entry points;
    ``deps`` are the headers the source includes, hashed with it.
    :attr:`log` keeps what the last build printed (``-Xptxas -v``:
    registers, shared memory, spills) and :attr:`seconds` how long it took.
    """

    def __init__(self, name: str, source: Path,
                 declare: Callable[[ctypes.CDLL], None],
                 deps: Sequence[Path] = ()):
        self.name = name
        self.source = source
        self.deps = tuple(deps)
        self.library = BUILD_DIR / f"lib{name}.so"
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.log = ""
        self.seconds = 0.0

    def build(self, force: bool = False) -> Path:
        """Compile the source into :attr:`library` unless a build of the
        same source and flags is already there.  The library is written to
        a temporary name and renamed into place, so concurrent builds
        never load a half-written file."""
        src = b"".join(p.read_bytes() for p in (self.source, *self.deps))
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()
        stamp = self.library.with_suffix(".sha256")
        if (not force and self.library.exists() and stamp.exists()
                and stamp.read_text() == digest):
            return self.library
        compiler = nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([compiler, *NVCC_FLAGS, "-o", tmp,
                               str(self.source)],
                              capture_output=True, text=True)
        self.seconds = time.perf_counter() - t0
        self.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{self.log}")
        os.replace(tmp, self.library)
        stamp.write_text(digest)
        return self.library

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib
