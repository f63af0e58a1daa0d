#!/usr/bin/env python3
"""Build variants of the port's Shiloach–Vishkin source and time each one
on the same adjacency, to find what bounds its step and its fixpoint:

    PYTHONPATH=src python3 tools/cc_variants.py [--extra NAME=FILE.cu ...]

Each variant is ``src/repro_torch/csrc/cc_hook.cu`` with a few lines
replaced (``VARIANTS``), built alone with ``nvcc`` into
``build/cc_variants/`` (all builds started together) and loaded with
``ctypes``; ``--extra`` adds a whole source of the same C entry points (an
older version, say), of which only the step is timed where it has no
fixpoint.  On ``knn_adjacency()`` of ``tools/torch_kernel_times.py`` each
variant's step runs on every step of the plain loop and its fixpoint on
the grid its planner picks; a variant meant to give the plain results is
checked first.  Times are CUDA events behind a checked
sleep (``tools/gpu_timing.py``).  One JSON line a variant, with ptxas'
registers, stack and spills of its kernels, then the card's name and
power limit and an empty launch timed the same way.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import statistics
import subprocess

import numpy as np
import torch

from gpu_timing import gpu_times
from repro_torch.kernels._build import CSRC, SIGNATURES, compile_library, ptxas_report
from repro_torch.kernels.cc_hook import cc_hook_ref
from torch_kernel_times import hook_steps, knn_adjacency

OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "cc_variants"
BLOCKS_AN_SM = "constexpr int kFixpointBlocks = 2;"
USE_VEC = "return k > 0 && k % 4 == 0 && reinterpret_cast<uintptr_t>(nbr) % 16 == 0;"
# name -> (replacements, whether the result must equal the plain version's)
VARIANTS = {
    "as committed": ([], True),
    "no kept lanes": ([("constexpr int kKeepBytes = 160 * 1024;",
                        "constexpr int kKeepBytes = 0;")], True),
    "fixpoint 3 blocks an SM": ([(BLOCKS_AN_SM, "constexpr int kFixpointBlocks = 3;")], True),
    "fixpoint 4 blocks an SM": ([(BLOCKS_AN_SM, "constexpr int kFixpointBlocks = 4;")], True),
    "no 16-byte cells": ([(USE_VEC, "return 0;")], True),
    # diagnostic: a lane's id in place of its parent, so no gather is made
    "no gathers": ([("return v >= 0 ? par[v] : INT_MAX;", "return v >= 0 ? v : INT_MAX;")],
                   False),
}


def build_all(sources):
    """Compile each (name -> source text) into its own shared library, all
    at once; returns name -> (path, ptxas report)."""
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, text) in enumerate(sources.items()):
        (OUT / f"v{i}.cu").write_text(text)
        paths[name] = (OUT / f"v{i}.cu", OUT / f"v{i}.so")
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        logs = {name: pool.submit(compile_library, [cu], so) for name, (cu, so) in paths.items()}
        return {name: (paths[name][1], ptxas_report(job.result()[1]))
                for name, job in logs.items()}


def bind(so):
    """The variant's library, its C entry points typed as the package's."""
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, restype
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cc_variants: needs a CUDA device")
    base = (CSRC / "cc_hook.cu").read_text()
    sources, exact = {}, {}
    for name, (reps, must_equal) in VARIANTS.items():
        text = base
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        sources[name], exact[name] = text, must_equal
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name], exact[name] = pathlib.Path(path).read_text(), True
    built = build_all(sources)

    nbr = knn_adjacency()
    n, k = nbr.shape
    steps, want = hook_steps(nbr, cc_hook_ref, "the plain step")
    stream = torch.cuda.current_stream().cuda_stream
    for name, (so, ptxas) in built.items():
        lib = bind(so)
        out = torch.empty(n, dtype=torch.int32, device=nbr.device)

        def step(p, lib=lib, out=out):
            if lib.cc_hook_step(nbr.data_ptr(), p.data_ptr(), out.data_ptr(), n, k, stream):
                raise SystemExit(f"{name}: step launch failed")
            return out
        rec = {"variant": name, "kernels": {
            e.function[-40:]: [e.registers, e.stack_bytes, e.spill_stores, e.spill_loads]
            for e in ptxas.values()}}
        if exact[name]:
            hook_steps(nbr, lambda nbr, p: step(p).clone(), name)
        rec["step_us"] = [1e3 * float(np.mean(gpu_times(
            [lambda p=p: step(p) for p in steps] * 10, per_sleep=100))) for _ in range(2)]
        if hasattr(lib, "cc_fixpoint") and exact[name]:
            buf = torch.empty(2 * n + 2, dtype=torch.int32, device=nbr.device)
            ptr = buf.data_ptr()
            plan = (ctypes.c_int * 3)()
            lib.cc_fixpoint_plan(n, k, ctypes.addressof(plan))

            def fix(lib=lib):
                if lib.cc_fixpoint(nbr.data_ptr(), ptr, ptr + 4 * n, ptr + 8 * n, n, k, 10_000,
                                   stream):
                    raise SystemExit(f"{name}: fixpoint launch failed")
            fix()
            torch.cuda.synchronize()
            if not (torch.equal(buf[:n], want) and int(buf[2 * n + 1]) == len(steps)):
                raise SystemExit(f"{name}: fixpoint != the plain loop")
            rec[f"fixpoint_us_{plan[0]}_blocks_{plan[1]}_kept"] = 1e3 * statistics.median(
                gpu_times([fix] * 30, per_sleep=30))
        print(json.dumps(rec), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "shape": [n, k], "steps": len(steps),
                      "valid_lanes": int((nbr >= 0).sum()), "empty_launch_us": 1e3 *
                      statistics.median(gpu_times([lambda: torch.cuda._sleep(0)] * 200,
                                                  per_sleep=100))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
