"""The port's hybrid data-parallel train step
(``repro_torch.training.trainer.make_hybrid_train_step``) against the JAX
package's ``make_hybrid_train_step``.

- The reference runs in a subprocess on 4 virtual CPU devices, mesh (2, 2)
  over ("data", "model"), with the spec trees the way its dry run makes
  them (``axis_rules(layout="tp")`` for the param, ZeRO and batch specs,
  then ``layout="hybrid"`` before tracing); the port runs on
  ``make_mesh((2, 2), ..., device="cpu")``.  Both start from the
  reference's ``init``, carried across by ``convert.lm_params_from_jax``,
  and take 3 steps of 4 × 32 at the qwen3-0.6b and granite-moe-1b-a400m
  smoke configs.  The losses agree within 0.02 (bf16 roundings, as
  ``test_torch_training.py`` explains) and every param within 2·Σ lr_t
  plus one bf16 ulp of its value: Adam's largest move a step, taken in
  opposite directions by the two packages, so an update whose sign a
  rounding flips still passes.  That bound alone would pass any update,
  so the params as a whole are held to the other run's move from the
  start: ||got − want|| ≤ ``MOVE_SHARE``·||want − start|| (0.02–0.17
  here), and at least ``BIT_EQUAL`` of them bit-equal (91–98% here).  A
  step that uses replica 0's gradient alone, or never writes the new
  params back, gives 0.90–1.09 and 15–45%, and one that drops the mean's
  division by D fails the loss bound.  The ZeRO specs the two steps scatter
  along are equal, and the port's step scatters each leaf along the dim
  its spec names.
- The port's hybrid step at 2 and 4 data replicas against its own
  ``make_train_step(microbatches=n)`` from the same start, within the
  same bounds, and its exchange's bytes.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.distribution import partition
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs
from repro_torch.models.api import build_model
from repro_torch.models.common import ShapeSpec
from repro_torch.models.convert import lm_params_from_jax, param_shapes
from repro_torch.training import optim, trainer

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
ARCHS = ("qwen3_0_6b", "granite_moe_1b_a400m")
SHAPE = ShapeSpec("hybrid", 32, 4, "train")
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=2)
LOSS_TOL = 0.02
MOVE_SHARE = 0.3
BIT_EQUAL = 0.75

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {src!r})
    import json
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs.registry import get_smoke_config
    from repro.distribution import partition
    from repro.launch import mesh as meshlib
    from repro.launch.specs import batch_logical, input_specs, make_batch
    from repro.models.api import build_model
    from repro.models.common import ShapeSpec
    from repro.training import optim
    from repro.training.trainer import make_hybrid_train_step

    spec = ShapeSpec("hybrid", 32, 4, "train")
    mesh = meshlib.make_mesh((2, 2), ("data", "model"))
    for arch in {archs!r}:
        cfg = get_smoke_config(arch)
        partition.set_axis_rules(meshlib.axis_rules(layout="tp"))
        partition.set_mesh_sizes(dict(zip(mesh.axis_names, mesh.devices.shape)))
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        pspecs = partition.param_specs(params, mesh)
        zspecs = partition.zero_specs(pspecs, params, mesh)
        bspecs = partition.resolve_spec_tree(input_specs(cfg, spec),
                                             batch_logical(cfg, spec), mesh)
        partition.set_axis_rules(meshlib.axis_rules(layout="hybrid"))
        step = jax.jit(make_hybrid_train_step(
            model, optim.OptConfig(**{opt!r}), mesh, zspecs, bspecs, pspecs=pspecs))
        state = optim.init_state(params)
        losses = []
        with mesh:
            for i in range({steps}):
                params, state, loss, _ = step(params, state, make_batch(cfg, spec, seed=i))
                losses.append(float(loss))
        out = {{"loss": np.array(losses, np.float32)}}
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            arr = np.asarray(leaf)
            key = "/".join(str(k.key) for k in path)
            out[key] = arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr
        np.savez(os.path.join({out!r}, arch + ".npz"), **out)
        zflat = jax.tree_util.tree_flatten_with_path(zspecs, is_leaf=lambda x: isinstance(x, P))[0]
        with open(os.path.join({out!r}, arch + ".json"), "w") as f:
            json.dump({{"/".join(str(k.key) for k in path): list(s) for path, s in zflat}}, f)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("hybrid")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = REFERENCE.format(src=SRC, archs=ARCHS, opt=OPT, steps=STEPS, out=str(out))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return out


def init_model(arch: str):
    """The smoke model on the CPU holding the reference's ``init``."""
    params = jax_build_model(jreg.get_smoke_config(arch)).init(jax.random.PRNGKey(0))
    model = build_model(registry.get_smoke_config(arch), device="cpu")
    return lm_params_from_jax(model, jax.tree.map(np.asarray, params))


def hybrid_step(model, mesh_shape, **kw):
    cfg = model.cfg
    mesh = meshlib.make_mesh(mesh_shape, ("data", "model"), device="cpu")
    partition.set_axis_rules(meshlib.axis_rules(layout="tp"))
    try:
        shapes = param_shapes(model)
        pspecs = partition.param_specs(shapes, mesh)
        zspecs = partition.zero_specs(pspecs, shapes, mesh)
        bspecs = partition.resolve_spec_tree(specs.input_specs(cfg, SHAPE),
                                             specs.batch_logical(cfg, SHAPE), mesh)
    finally:
        partition.set_axis_rules(None)
    return trainer.make_hybrid_train_step(model, optim.OptConfig(**OPT), mesh, zspecs, bspecs,
                                          pspecs=pspecs, **kw), zspecs


def train(model, step):
    state = optim.init_state(dict(model.named_parameters()))
    losses = []
    for i in range(STEPS):
        state, loss, _ = step(state, specs.make_batch(model.cfg, SHAPE, seed=i, device="cpu"))
        losses.append(float(loss))
    return losses, {n: p.detach().float() for n, p in model.named_parameters()}


def move_bound(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """2·Σ lr_t over the steps plus one bf16 ulp of each value."""
    cfg = optim.OptConfig(**OPT)
    lrs = sum(float(optim.schedule(cfg, torch.tensor(t, dtype=torch.int32)))
              for t in range(1, STEPS + 1))
    out = {}
    for name, p in params.items():
        ulp = torch.exp2(torch.floor(torch.log2(p.abs().clamp(min=2.0 ** -126))) - 7)
        out[name] = 2 * lrs + ulp
    return out


def norm(spec) -> tuple:
    """A spec as a tuple, a one-axis entry (a tuple or a JSON list) taken as
    its name."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else tuple(e) if isinstance(e, list) else e for e in spec)


def assert_within(got: dict, want: dict, start: dict, what: str):
    bound = move_bound(want)
    worst = {n: float(((got[n] - want[n]).abs() - bound[n]).max()) for n in want}
    bad = {n: w for n, w in worst.items() if w > 0}
    assert not bad, (what, bad)
    gap = sum(float((got[n] - want[n]).square().sum()) for n in want) ** 0.5
    move = sum(float((want[n] - start[n]).square().sum()) for n in want) ** 0.5
    assert gap <= MOVE_SHARE * move, (what, gap / move)
    equal = sum(int((got[n] == want[n]).sum()) for n in want)
    assert equal >= BIT_EQUAL * sum(want[n].numel() for n in want), (what, equal)


def snapshot(model) -> dict[str, torch.Tensor]:
    return {n: p.detach().float().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_hybrid_step_agrees_with_the_reference(reference, arch):
    model = init_model(arch)
    start = snapshot(model)
    step, zspecs = hybrid_step(model, (2, 2))
    losses, params = train(model, step)
    ref = np.load(reference / f"{arch}.npz")
    assert np.abs(np.array(losses) - ref["loss"]).max() <= LOSS_TOL, (losses, ref["loss"])
    tree = {k: (v.view(ml_dtypes.bfloat16) if v.dtype == np.uint16 else v)
            for k, v in ref.items() if k != "loss"}
    nested: dict = {}
    for key, leaf in tree.items():
        *head, last = key.split("/")
        node = nested
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf
    want = build_model(model.cfg, device="cpu")
    lm_params_from_jax(want, nested)
    assert_within(params, snapshot(want), start, arch)
    # the ZeRO specs the two steps scatter along
    with open(reference / f"{arch}.json") as f:
        ref_z = {k: norm(s) for k, s in json.load(f).items()}
    flat = {}

    def walk(node, prefix):
        for key, sub in node.items():
            if isinstance(sub, dict):
                walk(sub, prefix + (key,))
            else:
                flat["/".join(prefix + (key,))] = norm(sub)
    walk(zspecs, ())
    assert flat == ref_z
    # each leaf is scattered along the dim its ZeRO spec gives the data axis
    blocks = trainer._blocks(dict(model.named_parameters()), zspecs, {"data"}, 2)
    for name, (kind, owned) in blocks.items():
        path = "/".join(p for p in name.split(".") if not p.isdigit())
        n_stacked = sum(p.isdigit() for p in name.split("."))
        dims = [i for i, e in enumerate(ref_z[path])
                if e == "data" or (isinstance(e, tuple) and "data" in e)]
        if not dims:
            assert kind == "mean", name
        elif dims[0] < n_stacked:
            assert kind == "owner" and len(owned) == 1, name
        else:
            assert kind == "scatter" and len(owned) == 2, name
            d = dims[0] - n_stacked
            assert all(region[d] != slice(None) for _, region in owned), name


@pytest.mark.parametrize("replicas", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_hybrid_step_agrees_with_microbatched_steps(arch, replicas):
    model = init_model(arch)
    start = snapshot(model)
    step, _ = hybrid_step(model, (replicas, 1))
    losses, params = train(model, step)
    twin = init_model(arch)
    twin_losses, twin_params = train(twin, trainer.make_train_step(
        twin, optim.OptConfig(**OPT), microbatches=replicas))
    assert np.abs(np.array(losses) - np.array(twin_losses)).max() <= LOSS_TOL
    assert_within(params, twin_params, start, f"{arch} x{replicas}")
    # the exchange: fp32 gradients in, new params out, D-1 replicas' worth
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert step.bytes["scatter"] >= STEPS * (replicas - 1) * n_params * 4
    assert 0 < step.bytes["gather"] <= STEPS * (replicas - 1) * n_bytes
