"""Build the port's CUDA sources into one shared library and load it.

``nvcc`` compiles every ``csrc/*.cu`` into ``build/repro_torch/
libreprotorch.so`` (plain C entry points, no PyTorch headers, so a build
takes seconds), and ``ctypes`` loads it.  The build happens at the first
CUDA launch, never at import, so the CPU tests import every module without
``nvcc``; it is redone when a hash of the sources and flags changes.  A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libreprotorch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (argtypes, restype); every pointer and the stream are
# c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    "ell_propagate_step": ([_P] * 8 + [_I, _I, _I, _F, _I, _P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: pathlib.Path
    built: bool  # False when an up-to-date library was found on disk
    seconds: float  # wall time of the nvcc run (0.0 when not built)
    log: str  # nvcc's output (-Xptxas -v: registers, spills per kernel)

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry point returned a non-zero cudaError_t."""
        if code:
            msg = self.lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of repro_torch are built from source at their first launch")
    return nvcc


def build() -> tuple[pathlib.Path, bool, float, str]:
    """Compile the sources unless the library on disk matches their hash.

    Returns (path, built, seconds, log).  The library is written to a
    temporary name and renamed into place, so a concurrent reader never
    sees a half-written file.
    """
    digest = source_hash()
    path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if path.exists() and stamp.exists() and stamp.read_text() == digest:
        return path, False, 0.0, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    stamp.write_text(digest)
    return path, True, seconds, log


@functools.cache
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernels; the first call pays the build."""
    path, built, seconds, log = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return KernelLibrary(lib=lib, path=path, built=built, seconds=seconds, log=log)
