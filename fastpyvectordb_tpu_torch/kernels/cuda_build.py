"""Build and load the port's hand-written CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, in ``<build root>/kernels``
(``buildroot.py``: ``<repo>/build`` unless set), and bound with
``ctypes``.  Nothing is compiled when a module is imported: a wrapper
calls ``CudaSource.load()`` at its first launch, and ``build_all()`` starts
one ``nvcc`` per source at once and waits for all of them (the start-up
path of ``chip_smoke.py``).  A failed build raises with the compiler's
output; nothing falls back.  Each source has a lock: any number of threads
(a server's executor, the batcher's waves, a background rebuild) that need
a library at once wait for one ``nvcc`` and all get the one loaded
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

from .. import buildroot

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# ctypes argument types: a pointer (data_ptr, stream) and a C int
P = ctypes.c_void_p
I = ctypes.c_int


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


class CudaSource:
    """One ``csrc/<name>.cu`` and the C functions it exports:
    ``signatures`` maps each function name to its ``argtypes`` (every
    function returns the ``int`` of ``cudaGetLastError()``)."""

    def __init__(self, name: str, signatures: Dict[str, List]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()  # guards _proc, _lib and the build

    def _so(self) -> Path:
        # the shared headers (csrc/*.cuh) are part of every source
        deps = [self.source, *sorted(CSRC.glob("*.cuh"))]
        tag = hashlib.sha256(b"".join(p.read_bytes() for p in deps)
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return buildroot.path("kernels") / f"lib{self.name}_{tag}.so"

    def _tmp(self) -> Path:
        return self._so().with_suffix(f".{os.getpid()}.tmp")

    def start(self) -> None:
        """Start ``nvcc`` in the background unless the library is built."""
        with self._lock:
            self._start_locked()

    def _start_locked(self) -> None:
        if self._lib is not None or self._proc is not None \
                or self._so().exists():
            return
        self._so().parent.mkdir(parents=True, exist_ok=True)
        self._proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp()), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load(self) -> ctypes.CDLL:
        """The loaded library, compiling it first if needed."""
        lib = self._lib
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                self._lib = self._load_locked()
            return self._lib

    def _load_locked(self) -> ctypes.CDLL:
        self._start_locked()
        so = self._so()
        if self._proc is not None:
            out, _ = self._proc.communicate()
            rc = self._proc.returncode
            self._proc = None
            self.build_log = out
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({rc}):\n{out}")
            os.replace(self._tmp(), so)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in self.signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        return lib


def build_all(*sources: CudaSource) -> None:
    """Compile the given sources concurrently (one ``nvcc`` each) and load
    them; raises on the first failed build after all have finished."""
    for s in sources:
        s.start()
    errors = []
    for s in sources:
        try:
            s.load()
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def all_sources() -> List[CudaSource]:
    """Every hand-written source of the package, for ``build_all``."""
    from . import hamming_kernels, ivf_kernels, quant_kernels, s8_kernels
    return [quant_kernels.SOURCE, ivf_kernels.SOURCE, ivf_kernels.SOURCE_PQ,
            hamming_kernels.SOURCE, s8_kernels.SOURCE]
