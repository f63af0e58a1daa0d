#!/usr/bin/env python3
"""Time the port's argkmin and frontier-sweep kernels at the main path's
shapes, through the public wrappers only, so that the same script times
any version of ``repro_torch`` that ``PYTHONPATH`` names (two versions
compare within one run on one card):

    PYTHONPATH=src python3 tools/torch_kernel_times.py --label change \
        [--sweeps build/sweeps.npz]

Synthetic inputs are made with numpy from fixed seeds: argkmin at
(C, D, M) = (131072, 16, 8192) and D = 128, a store holding 103,192 rows
(10% dead) and a batch of 5,000 real rows padded to 8,192 (``k = 5``,
TK 13); the sweep at (N, K) = (107200, 24) with a third, 5% and all of the
rows on the frontier.  ``--sweeps`` adds the main path's own sweeps, as
``chip_smoke.py --save-sweeps`` wrote them: each checked against the plain
version's bits, then timed twice, and the means printed.  Each call is
timed with CUDA events behind a checked sleep (``tools/gpu_timing.py``);
medians and means are printed as one JSON line beside the card's name and
power limit, with an empty launch (PyTorch's spin kernel asked for 0
cycles) timed the same way.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from gpu_timing import gpu_times
from repro_torch.graph.knn import normalize_rows, selection_slack
from repro_torch.kernels.argkmin import argkmin_candidates
from repro_torch.kernels.ell_propagate import ell_propagate_ref, ell_propagate_step


def argkmin_args(d, seed=0, c=131072, m=8192, count=103192, real=5000):
    rng = np.random.default_rng(seed)
    emb = np.zeros((c, d), np.float32)
    emb[:count] = normalize_rows(rng.normal(size=(count, d)).astype(np.float32))
    base = count - m
    emb[base + real:count] = 0.0
    valid = np.zeros(c, bool)
    valid[:base] = rng.random(base) >= 0.1
    valid[base:base + real] = True
    kth = rng.uniform(0.4, 0.9, c).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in
            (emb, valid, kth, emb[base:count].copy(), np.arange(m) < real)]
    return args, base


def sweep_args(n=107_200, k=24, frontier=1 / 3, seed=1):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-1, n, size=(n, k)).astype(np.int32)
    wgt = (rng.uniform(0.1, 1.0, (n, k)) * (nbr >= 0)).astype(np.float32)
    wl0 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    wl1 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in
            (nbr, wgt, wl0, wl1, rng.random(n) < frontier,
             rng.uniform(0, 1, n).astype(np.float32))]


def saved_sweeps(path):
    """The main path's sweeps as ``chip_smoke.py --save-sweeps`` wrote them:
    (argument lists, delta)."""
    z = np.load(path)
    shared = [torch.from_numpy(z[name]).cuda() for name in ("nbr", "wgt", "wl0", "wl1")]
    frontier = torch.from_numpy(z["frontier"]).cuda()
    f = torch.from_numpy(z["f"]).cuda()
    return [shared + [frontier[i], f[i]] for i in range(frontier.shape[0])], float(z["delta"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--sweeps", metavar="NPZ", help="chip_smoke.py --save-sweeps output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = {"label": args.label, "card": card}
    for d in (16, 128):
        a, base = argkmin_args(d)
        slack = selection_slack(d)
        out[f"argkmin_d{d}_ms"] = statistics.median(gpu_times(
            [lambda: argkmin_candidates(*a, base, slack, k=5)] * 10, per_sleep=10))
    for share in (1 / 3, 0.05, 1.0):
        s = sweep_args(frontier=share)
        out[f"sweep_rows_{share:.2f}"] = int(s[4].sum())
        out[f"sweep_us_{share:.2f}"] = 1e3 * statistics.median(gpu_times(
            [lambda: ell_propagate_step(*s, delta=1e-4)] * 200, per_sleep=100))
    if args.sweeps:
        sweeps, delta = saved_sweeps(args.sweeps)
        for a in sweeps:
            got, want = ell_propagate_step(*a, delta=delta), ell_propagate_ref(*a, delta=delta)
            if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])):
                raise SystemExit("a main-path sweep: kernel != plain version")
        out["main_sweeps"] = len(sweeps)
        out["main_rows_mean"] = float(np.mean([int(a[4].sum()) for a in sweeps]))
        for rep in (1, 2):
            out[f"main_us_mean_{rep}"] = 1e3 * float(np.mean(gpu_times(
                [lambda a=a: ell_propagate_step(*a, delta=delta) for a in sweeps],
                per_sleep=100)))
    out["empty_launch_us"] = 1e3 * statistics.median(
        gpu_times([lambda: torch.cuda._sleep(0)] * 200, per_sleep=100))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
