"""Fused DynLP frontier sweep (Alg. 2 L23-32): CUDA kernel and plain version.

Counterpart of the Pallas TPU kernel ``repro.kernels.ell_propagate.
ell_propagate_step``.  The CUDA source is ``csrc/ell_propagate.cu`` (one
warp per 32 rows, reading the frontier rows' lanes coalesced; its header
says what bounds it on an H100).
``ell_propagate_ref`` is the same function in plain torch ops, with the
neighbor-axis sums in the kernel's column order, so the two give the same
bits.  The wrapper ``ell_propagate_step`` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors.

Outputs: ``F'`` (N,) float32 (only frontier rows move) and ``changed``
(N,) bool, ``|F' − F_u| > δ``.  ``f`` may be longer than ``nbr`` (Nf ≥ N):
row ``u`` reads ``F_u = f[min(u + row_offset, Nf − 1)]``, so a row block
can index a global label vector.
"""

from __future__ import annotations

import torch

from repro_torch.core.propagate import _delta, update_island


def ell_propagate_ref(nbr, wgt, wl0, wl1, frontier, f, delta=1e-4, row_offset=0):
    """Plain torch version of the sweep (the kernel's arithmetic, op for op)."""
    n = nbr.shape[0]
    rows = torch.clamp_max(
        torch.arange(n, device=f.device) + int(row_offset), f.shape[0] - 1)
    f_u = f[rows]
    mask = nbr >= 0
    f_v = f[torch.where(mask, nbr, 0)]
    f_new = torch.where(frontier, update_island(wgt, wl0, wl1, f_u, f_v, mask), f_u)
    return f_new, (f_new - f_u).abs() > _delta(delta, f.device)


def _check(nbr, wgt, wl0, wl1, frontier, f, row_offset):
    dev = f.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ell_propagate_step: unsupported device {dev}")
    if nbr.dim() != 2:
        raise ValueError(f"nbr must be (N, K), got shape {tuple(nbr.shape)}")
    n, k = nbr.shape
    want = (("nbr", nbr, torch.int32, (n, k)), ("wgt", wgt, torch.float32, (n, k)),
            ("wl0", wl0, torch.float32, (n,)), ("wl1", wl1, torch.float32, (n,)),
            ("frontier", frontier, torch.bool, (n,)))
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, f on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f.dtype != torch.float32 or f.dim() != 1 or not f.is_contiguous():
        raise TypeError(f"f must be a contiguous 1-D float32 tensor, got "
                        f"{f.dtype} {tuple(f.shape)}")
    if f.shape[0] < 1:
        raise ValueError("f must hold at least one label")
    if not 0 <= int(row_offset) < 2**31 - n:
        raise ValueError(f"row_offset={row_offset} out of range")
    if max(n * k, f.shape[0]) >= 2**31:
        raise ValueError("ell_propagate_step indexes with 32-bit ints")


def ell_propagate_step(nbr, wgt, wl0, wl1, frontier, f, delta=1e-4, row_offset=0):
    """One fused frontier sweep over ``nbr``'s rows.

    CPU tensors take ``ell_propagate_ref``; CUDA tensors launch the kernel
    on the current stream (building it at the first launch) and bump
    ``ell_propagate_step.launches``.  Nothing falls back: bad inputs or a
    refused launch raise.
    """
    _check(nbr, wgt, wl0, wl1, frontier, f, row_offset)
    if f.device.type == "cpu":
        return ell_propagate_ref(nbr, wgt, wl0, wl1, frontier, f, delta, row_offset)
    from repro_torch.kernels._build import load_library

    n, k = nbr.shape
    fout = torch.empty(n, dtype=torch.float32, device=f.device)
    changed = torch.empty(n, dtype=torch.uint8, device=f.device)
    if n == 0:
        return fout, changed.view(torch.bool)
    lib = load_library()
    stream = torch.cuda.current_stream(f.device).cuda_stream
    code = lib.lib.ell_propagate_step(
        nbr.data_ptr(), wgt.data_ptr(), wl0.data_ptr(), wl1.data_ptr(),
        frontier.data_ptr(), f.data_ptr(), fout.data_ptr(), changed.data_ptr(),
        n, k, f.shape[0], float(delta), int(row_offset), stream)
    lib.check(code, "ell_propagate_step launch")
    ell_propagate_step.launches += 1
    return fout, changed.view(torch.bool)


ell_propagate_step.launches = 0  # kernel launches since the last reset
