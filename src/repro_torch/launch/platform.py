"""Process-level platform setup: pick the card or the CPU and compose the
environment torch reads when CUDA initializes.

Counterpart of ``repro.launch.platform``.  ``set_platform`` must run before
CUDA initializes (before the first CUDA tensor, stream or device query
that creates the context): ``CUDA_VISIBLE_DEVICES`` and the caching
allocator's and the driver's settings are read once then and silently
ignored afterwards, so a late call on the process's own environment
raises instead of half-applying.  ``env=`` composes a child process's
environment instead.

The "gpu" set changes memory and loading only, never a value: the port's
paths hold the card's results bit for bit to their plain versions and to
the CPU, so TF32 stays off (``NVIDIA_TF32_OVERRIDE=0`` keeps it off in
cuBLAS whatever a caller asks of torch).  ``host_devices=N`` sets how many
shards ``launch.mesh.make_stream_mesh()`` gives on the CPU, the
counterpart of ``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import os

import torch

from repro_torch.launch.mesh import HOST_DEVICES_ENV

# One NAME=value per element so presence checks and merges stay trivial.
GPU_ENV_FLAGS: tuple[str, ...] = (
    "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True",  # less fragmentation
    "CUDA_MODULE_LOADING=LAZY",  # load a kernel's module at its first launch
    "NVIDIA_TF32_OVERRIDE=0",  # no TF32 in cuBLAS: fp32 products stay fp32
)


def _merge(env: dict, flags: tuple[str, ...]) -> None:
    """Set each ``NAME=value`` whose NAME ``env`` does not have yet."""
    for flag in flags:
        name, value = flag.split("=", 1)
        env.setdefault(name, value)


def set_platform(platform: str | None = None, *,
                 host_devices: int | None = None,
                 env: dict | None = None) -> dict:
    """Select the card or the CPU and install the platform's settings.

    ``platform`` is ``"cpu"`` (hides every card: ``CUDA_VISIBLE_DEVICES``
    empty) or ``"gpu"`` (merges ``GPU_ENV_FLAGS``; a variable ``env``
    already has wins, so launch scripts can still override, and a second
    call changes nothing); None applies ``host_devices`` alone.
    ``host_devices`` is the CPU's shard count for ``make_stream_mesh()``.

    Mutates and returns ``env`` (default ``os.environ``).  Raises
    RuntimeError when CUDA is already initialized and ``env`` is the real
    process environment: the settings would be silently dead.
    """
    if env is None:
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "set_platform() must run before CUDA initializes — its "
                "environment is read once, when the CUDA context is made. "
                "Call it first, or pass env= to build a child-process "
                "environment instead.")
        env = os.environ
    if platform is not None:
        if platform not in ("cpu", "gpu"):
            raise ValueError(f"unknown platform {platform!r}; want cpu or gpu")
        if platform == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        else:
            _merge(env, GPU_ENV_FLAGS)
    if host_devices is not None:
        if host_devices < 1:
            raise ValueError(f"host_devices must be >= 1, got {host_devices}")
        env[HOST_DEVICES_ENV] = str(int(host_devices))
    return env
