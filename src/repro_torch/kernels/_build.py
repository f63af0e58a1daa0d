"""Build the port's CUDA sources into one shared library and load it.

``nvcc`` compiles every ``csrc/*.cu`` into ``build/repro_torch/
libreprotorch.so`` (plain C entry points, no PyTorch headers, so a build
takes seconds), and ``ctypes`` loads it.  Each source compiles in its own
``nvcc`` process, all started together, and one more links the objects.
The build happens at the first CUDA launch, never at import, so the CPU
tests import every module without ``nvcc``; it is redone when a hash of
the sources and flags changes.  A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time

from repro_torch import telemetry

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libreprotorch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (argtypes, restype); every pointer and the stream are
# c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    "ell_propagate_step": ([_P] * 8 + [_I, _I, _I, _F, _I, _P], _I),
    "argkmin": ([_P] * 11 + [_I] * 8 + [_F, _P], _I),
    "argkmin_resident_blocks": ([_I, _I], _I),
    "bsr_spmv": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "cc_hook_step": ([_P] * 3 + [_I, _I, _P], _I),
    "cc_fixpoint": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "cc_fixpoint_plan": ([_I, _I, _P], _I),
    "knn_rerank": ([_P] * 4 + [_I] * 7 + [_P], _I),
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


def headers() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
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


def compile_library(srcs, out) -> tuple[float, str]:
    """Compile each of ``srcs`` in its own ``nvcc``, all started together,
    and link the objects into the shared library ``out``.  Returns
    (seconds, log); a failed compile or link raises with its output and
    leaves ``out`` as it was."""
    nvcc = find_nvcc()
    out = pathlib.Path(out)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as objdir:
        jobs = []
        for src in srcs:
            obj = pathlib.Path(objdir) / (pathlib.Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = ""
        failed = None
        for cmd, _, proc in jobs:
            text = proc.communicate()[0]
            log += text
            if proc.returncode != 0 and failed is None:
                failed = (proc.returncode, cmd, text)
        if failed is None:
            cmd = [nvcc, "-shared", "-o", str(out), *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = (proc.returncode, cmd, proc.stdout + proc.stderr)
    if failed is not None:
        code, cmd, text = failed
        raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{text}")
    return time.perf_counter() - t0, log


def build() -> tuple[pathlib.Path, bool, float, str]:
    """Compile the sources unless the library on disk matches their hash.

    Returns (path, built, seconds, log); an up-to-date library comes back
    with the log of the build that made it.  The library is written to a
    temporary name and renamed into place, so a concurrent reader never
    sees a half-written file.
    """
    digest = source_hash()
    path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    log_path = BUILD_DIR / (LIB_NAME + ".log")
    if path.exists() and stamp.exists() and stamp.read_text() == digest:
        return path, False, 0.0, log_path.read_text() if log_path.exists() else ""
    find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with telemetry.span("kernels.build"):
            seconds, log = compile_library(sources(), tmp)
        telemetry.count("kernels.builds")
    except BaseException:
        os.unlink(tmp)
        raise
    os.replace(tmp, path)
    log_path.write_text(log)
    stamp.write_text(digest)
    return path, True, seconds, log


@dataclasses.dataclass(frozen=True)
class PtxasEntry:
    function: str  # the mangled kernel name
    registers: int
    stack_bytes: int
    spill_stores: int
    spill_loads: int


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict[str, PtxasEntry]:
    """Registers, stack frame and spills of every kernel in an ``nvcc
    -Xptxas -v`` log, by mangled name (functions that are not kernels,
    which have no register line, are left out)."""
    regs, frames, cur = {}, {}, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            cur = m.group(1)
        elif m := _PROPS.search(line):
            cur = m.group(1)
        elif (m := _FRAME.search(line)) and cur:
            frames[cur] = tuple(int(x) for x in m.groups())
        elif (m := _REGS.search(line)) and cur:
            regs[cur] = int(m.group(1))
    return {name: PtxasEntry(name, n, *frames.get(name, (0, 0, 0)))
            for name, n in regs.items()}


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
