#!/usr/bin/env python3
"""Time the port's argkmin, frontier-sweep and Shiloach–Vishkin kernels at
the main path's shapes, through the public wrappers only, so that the same
script times any version of ``repro_torch`` that ``PYTHONPATH`` names (two
versions compare within one run on one card):

    PYTHONPATH=src python3 tools/torch_kernel_times.py --label change \
        [--sweeps build/sweeps.npz] [--only cc]

Synthetic inputs are made with numpy from fixed seeds: argkmin at
(C, D, M) = (131072, 16, 8192) and D = 128, a store holding 103,192 rows
(10% dead) and a batch of 5,000 real rows padded to 8,192 (``k = 5``,
TK 13); the sweep at (N, K) = (107200, 24) with a third, 5% and all of the
rows on the frontier; the hook step and the whole ``connected_components_cuda``
call at (N, K) = (107200, 24) on a kNN adjacency like a snapshot's (two
Gaussian classes in 16 dimensions, 5 nearest neighbors by cosine,
symmetrized, rows cut to 24), the step on every step of the fixpoint, each
checked against ``cc_hook_ref`` first, the call against the plain loop.
``--sweeps`` adds the main path's own sweeps, as
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

from gpu_timing import enqueue, gpu_times
from repro_torch.graph.knn import normalize_rows, selection_slack
from repro_torch.kernels import cc_hook
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


def knn_adjacency(n=107_200, k=24, d=16, knn=5, seed=3):
    """A symmetric kNN adjacency (PAD = -1) on the card: two Gaussian
    classes 6 apart in ``d`` dimensions (noise 0.9), each point's ``knn``
    nearest by cosine, both directions, each row cut to its first ``k``
    neighbors by id."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(2, d))
    centers *= 3.0 / np.linalg.norm(centers, axis=1, keepdims=True)
    centers[1] = -centers[0]
    emb = centers[rng.integers(0, 2, n)] + rng.normal(0, 0.9, (n, d))
    x = torch.nn.functional.normalize(torch.from_numpy(emb.astype(np.float32)).cuda(), dim=1)
    near = []
    for lo in range(0, n, 8192):
        sim = x[lo:lo + 8192] @ x.T
        rows = torch.arange(sim.shape[0], device=sim.device)
        sim[rows, lo + rows] = -2.0  # not its own neighbor
        near.append(sim.topk(knn, dim=1).indices)
    dst = torch.cat(near).cpu().numpy().reshape(-1)
    src = np.repeat(np.arange(n), knn)
    key = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    u, v = key // n, key % n
    start = np.searchsorted(u, np.arange(n))
    slot = np.arange(len(u)) - start[u]
    keep = slot < k
    nbr = np.full((n, k), -1, np.int32)
    nbr[u[keep], slot[keep]] = v[keep]
    return torch.from_numpy(nbr).cuda()


def hook_steps(nbr, step=None, what="cc_hook_step"):
    """The host loop of the hook step on ``nbr`` from the identity, one
    sync a step, with any version of the package: every step's input
    parent vector (the last, unchanged step's too) and the labels.  Each
    result of ``step`` (default: the package's ``cc_hook_step``) must equal
    ``cc_hook_ref``'s."""
    step = step or cc_hook.cc_hook_step
    par = torch.arange(nbr.shape[0], dtype=torch.int32, device=nbr.device)
    steps = []
    while True:
        new = step(nbr, par)
        if not torch.equal(new, cc_hook.cc_hook_ref(nbr, par)):
            raise SystemExit(f"{what}: a hook step != plain version")
        steps.append(par)
        if torch.equal(new, par):
            return steps, par
        par = new


def time_cc(out):
    """The hook step per launch on every step of the fixpoint, and the whole
    ``connected_components_cuda`` call (CUDA events around it, its host
    work and reads included), on ``knn_adjacency()``."""
    nbr = knn_adjacency()
    steps, par = hook_steps(nbr)
    labels, iters = cc_hook.connected_components_cuda(nbr)
    if iters != len(steps) or not torch.equal(labels, par):
        raise SystemExit("connected_components_cuda != the plain loop")
    out["cc_shape"] = list(nbr.shape)
    out["cc_valid_lanes"] = int((nbr >= 0).sum())
    out["cc_iterations"] = iters
    out["cc_components"] = int((labels == torch.arange(len(labels), device=labels.device)).sum())
    for rep in (1, 2):
        out[f"cc_step_us_mean_{rep}"] = 1e3 * float(np.mean(gpu_times(
            [lambda p=p: cc_hook.cc_hook_step(nbr, p) for p in steps] * 10, per_sleep=100)))
    cc_hook.connected_components_cuda(nbr)
    call = enqueue([lambda: cc_hook.connected_components_cuda(nbr)] * 30)  # each call syncs
    torch.cuda.synchronize()
    out["cc_call_us_median"] = 1e3 * statistics.median(s.elapsed_time(e) for s, e in call)
    if hasattr(cc_hook, "cc_fixpoint"):  # the fixpoint kernel alone, behind a sleep
        out["cc_fixpoint_us_median"] = 1e3 * statistics.median(gpu_times(
            [lambda: cc_hook.cc_fixpoint(nbr)] * 30, per_sleep=30))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--sweeps", metavar="NPZ", help="chip_smoke.py --save-sweeps output")
    ap.add_argument("--only", action="append", choices=("argkmin", "sweep", "cc"),
                    help="time only these kernels (repeatable; default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = {"label": args.label, "card": card}
    only = set(args.only or ("argkmin", "sweep", "cc"))
    for d in (16, 128) if "argkmin" in only else ():
        a, base = argkmin_args(d)
        slack = selection_slack(d)
        out[f"argkmin_d{d}_ms"] = statistics.median(gpu_times(
            [lambda: argkmin_candidates(*a, base, slack, k=5)] * 10, per_sleep=10))
    for share in (1 / 3, 0.05, 1.0) if "sweep" in only else ():
        s = sweep_args(frontier=share)
        out[f"sweep_rows_{share:.2f}"] = int(s[4].sum())
        out[f"sweep_us_{share:.2f}"] = 1e3 * statistics.median(gpu_times(
            [lambda: ell_propagate_step(*s, delta=1e-4)] * 200, per_sleep=100))
    if "cc" in only:
        time_cc(out)
    if args.sweeps and "sweep" in only:
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
