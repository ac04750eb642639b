"""Build a kernel source with ``nvcc`` into a shared library and load it with ``ctypes``.

Each kernel module keeps one ``KernelLibrary``. The first ``load()`` compiles the
source for ``sm_90a`` into ``build/tmv_tpu_torch/`` beside the package (a
directory git ignores), keyed by a hash of the source and the flags, and binds
the library's C functions; later calls return the loaded library. A failed
build raises with nvcc's stderr. ``log`` keeps nvcc's output (``-Xptxas -v``
prints each kernel's registers), ``seconds`` the time the build took.
``register_cuda_kernel`` makes a kernel's launch the CUDA implementation of its
``torch.library`` custom op.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tmv_tpu_torch"
SM90A_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the port's kernels are built with nvcc at first use")


class KernelLibrary:
    """One CUDA source, built once per process and bound through ``bind``."""

    def __init__(self, source: Path, flags: List[str], bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.flags = flags
        self.bind = bind
        self.log = ""
        self.seconds = 0.0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            t0 = time.perf_counter()
            digest = hashlib.sha256(self.source.read_bytes() + " ".join(self.flags).encode())
            lib_path = BUILD_DIR / f"lib{self.source.stem}_{digest.hexdigest()[:16]}.so"
            if not lib_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
                cmd = [nvcc_path(), *self.flags, "-o", str(tmp), str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
                self.log = proc.stdout + proc.stderr
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            self.bind(lib)
            lib.tmv_cuda_error_string.restype = ctypes.c_char_p
            lib.tmv_cuda_error_string.argtypes = [ctypes.c_int]
            self.seconds = time.perf_counter() - t0
            self._lib = lib
            return lib

    def check(self, err: int, what: str):
        """Raise if a launch returned a CUDA error code other than 0."""
        if err != 0:
            raise RuntimeError(f"{what} launch failed: cudaError {err} "
                               f"({self._lib.tmv_cuda_error_string(err).decode()})")


def register_cuda_kernel(op, kernel: Callable):
    """Register ``kernel`` as the CUDA implementation of the custom op ``op`` and keep
    it in the op's table as it is: ``register_kernel`` wraps it in
    ``torch._disable_dynamo``, and inside a traced program run on the card that wrapper
    cost more host time per call than the launch itself (``PERF.md`` §6)."""
    op.register_kernel("cuda")(kernel)
    op._backend_fns["cuda"] = kernel
