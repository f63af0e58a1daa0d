"""Named meshes over a ``DeviceMesh``, the logical-axis rule sets, and the
H100's constants for the dry run's bound.

Counterpart of ``repro.launch.mesh``.  The reference builds
``jax.sharding.Mesh``es; here ``make_mesh`` gives a ``NamedMesh``: axis
names and a numpy array of ``torch.device``s of the mesh's shape (the
reference mesh's ``axis_names`` and ``devices.shape``), over the flat
``DeviceMesh`` of its shards.  The production meshes (256 and 512 TPU
chips) become shapes and names only, for the partition rules: no such
devices exist here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.distributed import DeviceMesh
from repro_torch.device import resolve_device

# NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet: dense rates without
# sparsity at the full 700 W power limit.
PEAK_FLOPS_BF16 = 989e12  # bf16/fp16 on the tensor cores
PEAK_FLOPS_F32 = 67e12  # float32 outside the tensor cores (TF32 stays off)
HBM_BW = 3.35e12  # bytes/s
# NVLink is not used on one card, so no link rate is set.

# The environment variable that sets how many shards ``make_stream_mesh()``
# gives on the CPU (``launch.platform.set_platform(host_devices=N)``).
HOST_DEVICES_ENV = "REPRO_FORCE_HOST_DEVICES"


class NamedMesh:
    """A mesh with named axes: ``axis_names`` and ``devices``, a numpy
    object array of the mesh's shape holding each shard's ``torch.device``
    (None in a mesh of shape and names only); ``device_mesh`` is the flat
    ``DeviceMesh`` of the shards in row-major order, or None."""

    def __init__(self, shape, axes, device_mesh: DeviceMesh | None = None):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
        self.axis_names = axes
        self.device_mesh = device_mesh
        self.devices = np.empty(shape, dtype=object)
        if device_mesh is not None:
            if device_mesh.n_devices != self.devices.size:
                raise ValueError(f"{device_mesh} does not fill a {shape} mesh")
            self.devices.reshape(-1)[:] = device_mesh.devices

    def __repr__(self) -> str:
        return f"NamedMesh({dict(zip(self.axis_names, self.devices.shape))}, {self.device_mesh})"


def make_mesh(shape, axes, device: str | torch.device | None = None) -> NamedMesh:
    """A named mesh of ``shape`` over ``axes`` on ``device`` (``None`` →
    ``cuda``, raising without a card; ``"cpu"`` for the tests).  On
    ``cuda`` with as many visible cards as shards, a shard a card; else
    every shard on the one device, as ``DeviceMesh.local`` places them."""
    n = int(np.prod(shape))
    dev = resolve_device(device)
    if dev == torch.device("cuda") and torch.cuda.device_count() == n:
        return NamedMesh(shape, axes, DeviceMesh.visible())
    return NamedMesh(shape, axes, DeviceMesh.local(n, dev))


def host_devices() -> int:
    """The shards ``make_stream_mesh()`` gives on the CPU: the environment's
    ``REPRO_FORCE_HOST_DEVICES`` (``set_platform(host_devices=N)``), else 1."""
    return int(os.environ.get(HOST_DEVICES_ENV, "1"))


def make_stream_mesh(n_devices: int | None = None,
                     device: str | torch.device | None = None) -> DeviceMesh:
    """The flat mesh sharded streaming wants (``StreamEngine(mesh=...)``):
    ``n_devices`` shards on ``device`` (``DeviceMesh.local``), or with
    ``n_devices=None`` one shard per visible card (``DeviceMesh.visible``)
    or, on the CPU, ``host_devices()`` shards."""
    dev = resolve_device(device)
    if n_devices is None:
        if dev.type == "cuda":
            return DeviceMesh.visible()
        n_devices = host_devices()
    return DeviceMesh.local(n_devices, dev)


def make_production_mesh(*, multi_pod: bool = False) -> NamedMesh:
    """The reference's production mesh as shape and names only: 16×16
    ("data", "model"), or 2×16×16 with a leading "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return NamedMesh(shape, axes)


def axis_rules(multi_pod: bool = False, layout: str = "tp") -> dict:
    """Logical→mesh axis mapping installed before tracing.

    Layouts (the physical mesh never changes):
      tp      — batch over data axes, tensor/sequence/expert over "model".
      dp      — pure data parallel: batch over EVERY axis, weights
                replicated (the right shape for sub-1B models where TP
                collectives dwarf compute).
      tp_nosp — tensor parallel without sequence-parallel resharding.
      hybrid  — manual data parallelism (``make_hybrid_train_step``): batch
                locality is implicit inside the manual region, so "dp" must
                not appear in constraints.
    """
    pods = ("pod",) if multi_pod else ()
    if layout == "hybrid":
        return {"dp": None, "tp": "model", "sp": "model", "ep": "model"}
    if layout == "dp":
        return {
            "dp": pods + ("data", "model"),
            "tp": None, "sp": None, "ep": None,
        }
    if layout == "tp_nosp":
        return {
            "dp": pods + ("data",),
            "tp": "model", "sp": None, "ep": "model",
        }
    return {
        "dp": pods + ("data",),
        "tp": "model",
        "sp": "model",  # sequence-parallel residual stream
        "ep": "model",  # expert parallelism shares the model axis
    }
