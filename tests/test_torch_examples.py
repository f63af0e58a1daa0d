"""The port's examples run end to end on the CPU, at a small size, with
their inline assertions: ``examples/torch_quickstart.py`` (accuracy
against the ground truth ≥ 0.99, as the reference's quickstart reaches,
and agreement with the harmonic optimum > 0.97), ``torch_dynamic_stream.py``
(its four parts, the 8-shard mesh on the CPU included),
``torch_serve_lp.py``, ``torch_serve_lm.py`` (qwen3-0.6b's smoke config,
h2o-danube-3-4b's, whose cache is a ring buffer, xlstm-350m's, whose
cache holds recurrent states, zamba2-7b's, whose cache holds Mamba2
states beside the shared block's k and v, and whisper-medium's, whose cache
holds a decoder's self k and v beside the cross k and v of its encoder's
output) and
``torch_semi_supervised_lm.py`` (curation, then 30 training steps of the
smoke config: pseudo-label quality and purity > 0.9, last loss < first)."""

import importlib.util
import pathlib

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart():
    out = _load("torch_quickstart").main(device="cpu", vertices=1500, batch_size=500)
    assert out["accuracy"] >= 0.99
    assert out["agreement"] > 0.97
    # paper Fig. 7: ITLP recomputes from scratch, DynLP only the affected set
    assert out["itlp_iterations"] > out["dynlp_iterations"]


def test_dynamic_stream():
    ex = _load("torch_dynamic_stream")
    assert ex.deletion_demo("cpu") > 0.5
    batches, allocations = ex.streaming_demo("cpu", vertices=600, batch_size=30)
    assert batches == 20 and allocations < batches
    assert ex.backend_demo("cpu") < 20 * 1e-3
    plans, rungs = ex.mesh_demo("cpu", vertices=240, batch_size=40)
    assert plans == rungs >= 1


def test_serve_lp():
    ex = _load("torch_serve_lp")
    assert ex.estimator_quickstart("cpu") == 1.0
    st = ex.serving_demo("cpu", vertices=300, batch_size=60)
    assert st.batches_committed == 5 and st.queries_while_inflight > 0
    assert ex.backpressure_demo("cpu").rejected == 1
    assert ex.async_driver_demo("cpu").deadline_admissions >= 1


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "h2o-danube-3-4b", "xlstm-350m", "zamba2-7b",
                                  "whisper-medium"])
def test_serve_lm(arch):
    engine, done = _load("torch_serve_lm").main("cpu", arch=arch)
    assert len(done) == 6 and engine.steps > 0
    assert engine.decode_calls == engine.prefill_calls + engine.steps


def test_semi_supervised_lm(tmp_path):
    ex = _load("torch_semi_supervised_lm")
    out = ex.main(["--device", "cpu", "--steps", "30", "--ckpt-dir", str(tmp_path),
                   "--ckpt-every", "20"])
    assert out["quality"] > 0.9 and out["purity"] > 0.9 and out["sweeps"] > 0
    assert len(out["losses"]) == 30 and out["losses"][-1] < out["losses"][0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000020"]


def test_examples_import_neither_jax_nor_the_reference():
    for name in ("torch_quickstart", "torch_dynamic_stream", "torch_serve_lp",
                 "torch_serve_lm", "torch_semi_supervised_lm"):
        src = (EXAMPLES / f"{name}.py").read_text()
        assert "import jax" not in src and "from repro." not in src and \
            "import repro\n" not in src, name
