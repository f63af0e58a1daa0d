"""The port's input specs and training driver (``repro_torch.launch``)
against the JAX package's ``repro.launch``.

- ``input_specs``/``make_batch`` for all ten configs × the ``ShapeSpec``
  kinds: shapes and dtypes equal; every leaf byte-identical (int32 draws
  and the bf16 ``vis_embeds``/``frames``, which both packages round from
  float64 through fp32); ``synthetic_batch`` byte-identical (qwen3-0.6b's
  and whisper-medium's smoke configs).
- ``launch.train.main`` at qwen3-0.6b's smoke config against the
  reference's ``main``, both resumed from one step-0 checkpoint of the
  reference's ``init``: the loss lists within 0.02 (measured ≤ 0.0020;
  bf16 roundings, as ``test_torch_training.py`` explains).
- A checkpoint the reference's ``main`` wrote at step 3 resumed by the
  port's ``main`` to step 6, and the other way round: the resumed losses
  within 0.02 of the uninterrupted runs' (measured ≤ 0.0018), and the
  manifests the two packages write at step 3 byte-identical.  The port
  resumed from its own step 3 repeats its uninterrupted losses exactly.
"""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models.api import build_model as jax_build_model
from repro.training import optim as joptim
from repro_torch.configs import registry
from repro_torch.launch import specs, train
from repro_torch.models.common import ShapeSpec

torch.set_num_threads(1)

KINDS = [ShapeSpec("train", 64, 2, "train"), ShapeSpec("prefill", 64, 2, "prefill"),
         ShapeSpec("decode", 64, 2, "decode"), ShapeSpec("odd", 12, 3, "train")]
LOSS_TOL = 0.02


def _bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("shape", KINDS, ids=lambda s: s.name)
@pytest.mark.parametrize("name", jreg.ARCH_IDS)
def test_specs_and_batches_equal_the_references(name, shape):
    for smoke in (False, True):
        cfg = registry.get_smoke_config(name) if smoke else registry.get_config(name)
        jcfg = jreg.get_smoke_config(name) if smoke else jreg.get_config(name)
        jshape = jcommon.ShapeSpec(**dataclasses.asdict(shape))
        got, want = specs.input_specs(cfg, shape), jspecs.input_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            assert got[k].device.type == "meta"
        if not smoke:
            continue
        for seed in (0, 3):
            b, jb = specs.make_batch(cfg, shape, seed, device="cpu"), \
                jspecs.make_batch(jcfg, jshape, seed)
            assert list(b) == list(jb)
            for k in jb:
                assert tuple(b[k].shape) == jb[k].shape, k
                assert np.array_equal(_bytes(b[k]), _bytes(np.asarray(jb[k]))), (k, seed)
    assert specs.vlm_split(64) == jspecs.vlm_split(64)


@pytest.mark.parametrize("name", ["qwen3_0_6b", "whisper_medium"])
def test_synthetic_batch_equals_the_reference(name):
    """Every leaf byte-identical; the audio family's ``tokens``/``labels``
    ramp ``seq`` tokens a row, beside ``seq`` frames, as the reference's."""
    cfg, jcfg = registry.get_smoke_config(name), jreg.get_smoke_config(name)
    for step in (0, 1, 17):
        b = train.synthetic_batch(cfg, 4, 16, step, device="cpu")
        jb = jtrain.synthetic_batch(jcfg, 4, 16, step)
        assert list(b) == list(jb)
        for k in jb:
            assert tuple(b[k].shape) == jb[k].shape, (k, step)
            assert str(b[k].dtype).split(".")[-1] == str(jb[k].dtype), (k, step)
            assert np.array_equal(_bytes(b[k]), _bytes(np.asarray(jb[k]))), (k, step)
        assert b["tokens"].shape == (4, 16) and b["tokens"].dtype == torch.int32


ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "6", "--batch", "4", "--seq", "16",
        "--ckpt-every", "3", "--log-every", "100"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One step-0 checkpoint of the reference's init and optimizer state,
    copied for each run; both mains run 6 steps from it."""
    root = tmp_path_factory.mktemp("train")
    jm = jax_build_model(jreg.get_smoke_config("qwen3_0_6b"))
    params = jm.init(jax.random.PRNGKey(0))
    jckpt.save(str(root / "init"), 0, {"params": params, "opt": joptim.init_state(params)})
    for d in ("ref", "port"):
        shutil.copytree(root / "init", root / d)
    ref = jtrain.main(ARGS + ["--ckpt-dir", str(root / "ref")])
    port = train.main(ARGS + ["--ckpt-dir", str(root / "port"), "--device", "cpu"])
    return root, ref, port


def test_main_equals_the_references(runs):
    _, ref, port = runs
    assert len(ref) == len(port) == 6
    np.testing.assert_allclose(port, ref, atol=LOSS_TOL)
    assert port[-1] < port[0]


def test_training_checkpoints_resume_across_packages(runs):
    root, ref, port = runs
    # the manifests of the step-3 checkpoints the two mains wrote
    m_ref = (root / "ref" / "step_00000003" / "manifest.json").read_bytes()
    m_port = (root / "port" / "step_00000003" / "manifest.json").read_bytes()
    assert m_ref == m_port
    leaves = json.loads(m_port)["leaves"]
    assert leaves[0]["path"] == "['opt']['m']['embed']" and leaves[-1]["path"] == \
        "['params']['lm_head']"
    # a run killed after step 3: drop step 6, resume in the other package
    for src, cut in (("ref", "ref_cut"), ("port", "port_cut"), ("port", "port_own")):
        shutil.copytree(root / src, root / cut)
        shutil.rmtree(root / cut / "step_00000006")
    by_port = train.main(ARGS + ["--ckpt-dir", str(root / "ref_cut"), "--device", "cpu"])
    by_ref = jtrain.main(ARGS + ["--ckpt-dir", str(root / "port_cut")])
    assert len(by_port) == len(by_ref) == 3
    np.testing.assert_allclose(by_port, ref[3:], atol=LOSS_TOL)
    np.testing.assert_allclose(by_ref, port[3:], atol=LOSS_TOL)
    np.testing.assert_allclose(by_port, port[3:], atol=LOSS_TOL)
    own = train.main(ARGS + ["--ckpt-dir", str(root / "port_own"), "--device", "cpu"])
    assert own == port[3:]
