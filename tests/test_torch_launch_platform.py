"""``repro_torch.launch.platform``: environment composition, the four cases
of ``tests/test_launch_platform.py``.

Pure env-dict tests: the helper takes ``env=`` so that tests (and launch
scripts building child environments) never race CUDA's one-shot
initialization.  The late-call case stubs ``torch.cuda.is_initialized``,
since this machine has no card to initialize.
"""

import pytest
import torch

from repro_torch.launch import mesh as meshlib
from repro_torch.launch.platform import GPU_ENV_FLAGS, set_platform


def test_gpu_platform_installs_flag_set():
    env = set_platform("gpu", env={})
    for flag in GPU_ENV_FLAGS:
        name, value = flag.split("=", 1)
        assert env[name] == value
    assert env["NVIDIA_TF32_OVERRIDE"] == "0"  # no flag that changes a result
    assert "CUDA_VISIBLE_DEVICES" not in env


def test_existing_flags_win_and_merge_is_idempotent():
    env = {"PYTORCH_CUDA_ALLOC_CONF": "max_split_size_mb:128"}
    set_platform("gpu", env=env)
    # the user's value survives; the helper never writes a variable twice
    assert env["PYTORCH_CUDA_ALLOC_CONF"] == "max_split_size_mb:128"
    before = dict(env)
    set_platform("gpu", env=env)
    assert env == before
    assert set(env) == {flag.split("=", 1)[0] for flag in GPU_ENV_FLAGS}


def test_host_devices_forces_virtual_cpu_count(monkeypatch):
    env = set_platform("cpu", host_devices=8, env={})
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env[meshlib.HOST_DEVICES_ENV] == "8"
    # platform=None still applies host_devices (keeps the card visible)
    env2 = set_platform(host_devices=4, env={})
    assert "CUDA_VISIBLE_DEVICES" not in env2
    assert env2[meshlib.HOST_DEVICES_ENV] == "4"
    # and make_stream_mesh() gives that many shards on the CPU
    monkeypatch.setenv(meshlib.HOST_DEVICES_ENV, env2[meshlib.HOST_DEVICES_ENV])
    mesh = meshlib.make_stream_mesh(device="cpu")
    assert mesh.n_devices == 4 and mesh.distinct == (torch.device("cpu"),)
    assert meshlib.make_stream_mesh(3, device="cpu").n_devices == 3


def test_validation_and_late_call_guard(monkeypatch):
    with pytest.raises(ValueError, match="unknown platform"):
        set_platform("quantum", env={})
    with pytest.raises(ValueError, match="host_devices"):
        set_platform("cpu", host_devices=0, env={})
    # CUDA initialized in this process: mutating os.environ would be dead
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="before CUDA"):
        set_platform("cpu")
    assert set_platform("cpu", env={})["CUDA_VISIBLE_DEVICES"] == ""
