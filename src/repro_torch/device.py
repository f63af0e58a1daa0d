"""The port's device rule: entry points run on the card unless asked not to.

Every entry point (``DynLP``, ``build_problem``, ``run_propagation``,
``problem_from_arrays``) takes ``device=None``; ``None`` means ``cuda``.
With no CUDA device present that is an error, never a silent move to the
CPU: a caller who wants the CPU (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` → ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
