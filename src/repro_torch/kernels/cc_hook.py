"""Shiloach–Vishkin hook + jump step (paper Fig. 2): CUDA kernel and plain
version.

Counterpart of the Pallas TPU kernel ``repro.kernels.cc_hook.cc_hook_step``
and its loop ``connected_components_pallas``.  One step hooks each vertex
to the smallest parent among itself and its neighbors, then jumps once
through the PREVIOUS parent vector:

    hooked[u] = min(par[u], min_{v ∈ N(u)} par[v]);   out[u] = par[hooked[u]]

The CUDA source is ``csrc/cc_hook.cu`` (one thread per row).  Labels are
exact integers, so the kernel and ``cc_hook_ref`` agree exactly.  The
wrapper ``cc_hook_step`` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors.  ``connected_components_cuda`` loops
the step to its fixpoint; ``DynLP`` and ``StreamEngine`` use
``core.components.connected_components`` instead, as the reference does.
"""

from __future__ import annotations

import torch


def cc_hook_ref(nbr: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """Plain torch version of one fused hook + jump step."""
    mask = nbr >= 0
    own = torch.arange(nbr.shape[0], dtype=nbr.dtype, device=nbr.device)
    idx = torch.where(mask, nbr, own[:, None])
    nbr_par = torch.where(mask, par[idx.long()], torch.iinfo(torch.int32).max)
    hooked = par
    if nbr.shape[1]:
        hooked = torch.minimum(par, nbr_par.amin(dim=1))
    return par[hooked.long()]


def _check(nbr, par):
    dev = par.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"cc_hook_step: unsupported device {dev}")
    if nbr.dim() != 2:
        raise ValueError(f"nbr must be (N, K), got shape {tuple(nbr.shape)}")
    n, k = nbr.shape
    for name, t, shape in (("nbr", nbr, (n, k)), ("par", par, (n,))):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, par on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n * k >= 2**31:
        raise ValueError("cc_hook_step indexes nbr with 32-bit ints")


def cc_hook_step(nbr: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """One fused hook + jump step over ``nbr``'s rows; returns the new
    ``(N,)`` int32 parent vector.

    CPU tensors take ``cc_hook_ref``; CUDA tensors launch the kernel on the
    current stream (building it at the first launch) and bump
    ``cc_hook_step.launches``.  The ids are not read on the host: the
    caller guarantees ``nbr < N`` and ``0 <= par < N``."""
    _check(nbr, par)
    if par.device.type == "cpu":
        return cc_hook_ref(nbr, par)
    from repro_torch.kernels._build import load_library

    n, k = nbr.shape
    out = torch.empty(n, dtype=torch.int32, device=par.device)
    if n == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(par.device).cuda_stream
    code = lib.lib.cc_hook_step(nbr.data_ptr(), par.data_ptr(), out.data_ptr(), n, k, stream)
    lib.check(code, "cc_hook_step launch")
    cc_hook_step.launches += 1
    return out


cc_hook_step.launches = 0  # kernel launches since the last reset


def connected_components_cuda(nbr: torch.Tensor,
                              max_iters: int = 10_000) -> tuple[torch.Tensor, int]:
    """Shiloach–Vishkin over a symmetric ELL adjacency (PAD = -1), built on
    ``cc_hook_step``: hook + jump until no parent moves, one host sync per
    step.  Returns ``(par, iterations)``; ``par[u]`` is the smallest vertex
    id of ``u``'s component, and ``iterations`` counts every step, the
    last (unchanged) one included, as ``connected_components_pallas``
    does."""
    par = torch.arange(nbr.shape[0], dtype=torch.int32, device=nbr.device)
    it, changed = 0, True
    while changed and it < max_iters:
        new = cc_hook_step(nbr, par)
        changed = bool((new != par).any())
        par, it = new, it + 1
    return par, it
