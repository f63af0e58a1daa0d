"""Shiloach–Vishkin hook + jump step (paper Fig. 2) and its fixpoint: CUDA
kernels and plain versions.

Counterpart of the Pallas TPU kernel ``repro.kernels.cc_hook.cc_hook_step``
and its loop ``connected_components_pallas``.  One step hooks each vertex
to the smallest parent among itself and its neighbors, then jumps once
through the PREVIOUS parent vector:

    hooked[u] = min(par[u], min_{v ∈ N(u)} par[v]);   out[u] = par[hooked[u]]

The CUDA source is ``csrc/cc_hook.cu``: a warp-cooperative step, and the
whole loop to its fixpoint in one cooperative launch, both on one step
body.  Labels are exact integers, so the kernels and their plain versions
(``cc_hook_ref``, ``connected_components_ref``) agree exactly.  Each
wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors.  ``DynLP`` and ``StreamEngine`` use
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


def connected_components_ref(nbr: torch.Tensor, max_iters: int = 10_000,
                             step=cc_hook_ref) -> tuple[torch.Tensor, int]:
    """Plain version of the fixpoint: ``step`` (``cc_hook_ref``, or the
    kernel ``cc_hook_step`` for the one-launch-a-step loop) looped on the
    host, one sync per step, until no parent moves or ``max_iters`` steps
    ran.  Returns ``(par, iterations)`` as ``connected_components_pallas``
    does: the last (unchanged) step is counted."""
    par = torch.arange(nbr.shape[0], dtype=torch.int32, device=nbr.device)
    it, changed = 0, True
    while changed and it < max_iters:
        new = step(nbr, par)
        changed = bool((new != par).any())
        par, it = new, it + 1
    return par, it


def _check(nbr, par=None):
    dev = nbr.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"cc_hook: unsupported device {dev}")
    if nbr.dim() != 2:
        raise ValueError(f"nbr must be (N, K), got shape {tuple(nbr.shape)}")
    n, k = nbr.shape
    for name, t, shape in (("nbr", nbr, (n, k)), ("par", par, (n,))):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, nbr on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n * k >= 2**31:
        raise ValueError("cc_hook indexes nbr with 32-bit ints")


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


def cc_fixpoint(nbr: torch.Tensor,
                max_iters: int = 10_000) -> tuple[torch.Tensor, torch.Tensor]:
    """The Shiloach–Vishkin loop to its fixpoint, read back nowhere: returns
    ``(par, iterations)`` as tensors on ``nbr``'s device, ``(N,)`` int32
    and a scalar int32, with ``connected_components_ref``'s values.

    CPU tensors take ``connected_components_ref``.  CUDA tensors launch one
    cooperative kernel on the current stream over every block the card
    holds at once (at most what the rows need); it runs every step (each
    on the hook step's body, a grid barrier between steps) and stops on
    the card.  Each launch bumps ``connected_components_cuda.launches``; a
    refused launch raises."""
    _check(nbr)
    n, k = nbr.shape
    if nbr.device.type == "cpu":
        par, it = connected_components_ref(nbr, max_iters)
        return par, torch.tensor(it, dtype=torch.int32)
    from repro_torch.kernels._build import load_library

    max_iters = max(0, min(int(max_iters), 2**31 - 1))
    if n == 0:  # one step over no rows moves nothing, as the reference counts it
        par = torch.empty(0, dtype=torch.int32, device=nbr.device)
        return par, torch.tensor(min(1, max_iters), dtype=torch.int32, device=nbr.device)
    # one allocation: two parent buffers (the first ends holding the
    # labels), then the last step that moved a parent and the steps run,
    # all written by the kernel
    buf = torch.empty(2 * n + 2, dtype=torch.int32, device=nbr.device)
    lib = load_library()
    stream = torch.cuda.current_stream(nbr.device).cuda_stream
    ptr = buf.data_ptr()
    code = lib.lib.cc_fixpoint(nbr.data_ptr(), ptr, ptr + 4 * n, ptr + 8 * n, n, k, max_iters,
                               stream)
    lib.check(code, "cc_fixpoint cooperative launch")
    connected_components_cuda.launches += 1
    return buf[:n], buf[2 * n + 1]


def connected_components_cuda(nbr: torch.Tensor,
                              max_iters: int = 10_000) -> tuple[torch.Tensor, int]:
    """Shiloach–Vishkin over a symmetric ELL adjacency (PAD = -1): hook +
    jump until no parent moves.  Returns ``(par, iterations)``; ``par[u]``
    is the smallest vertex id of ``u``'s component, and ``iterations``
    counts every step, the last (unchanged) one included, as
    ``connected_components_pallas`` does.  On the card the whole loop is
    one launch (``cc_fixpoint``) and one read of the step count."""
    par, it = cc_fixpoint(nbr, max_iters)
    return par, int(it)


connected_components_cuda.launches = 0  # fixpoint kernel launches since the last reset

