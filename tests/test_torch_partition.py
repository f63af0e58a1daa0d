"""The port's partition specs (``repro_torch.distribution.partition``)
against the JAX package's ``repro.distribution.partition``.

- Every case of ``tests/test_partition.py`` through both packages on the
  same inputs.
- For all ten configs' smoke parameter trees (the reference's from
  ``jax.eval_shape(init)``, the port's from a meta-device build through
  ``convert.param_shapes``), on meshes (4, 4) and (2, 16, 16) of fake axis
  sizes: ``param_specs`` and ``zero_specs`` equal leaf for leaf (a
  one-axis tuple taken as its name), ``zero_specs`` idempotent, and
  ``convert._ref_key`` taking each port parameter to its stacked leaf,
  with one stacked index a dim the port's tensor lacks;
  ``resolve_spec_tree`` of ``input_specs``/
  ``batch_logical`` equal for every config and ``SHAPES`` entry, and of
  ``cache_shape``/``cache_logical`` (through the model's ``CACHE_TREE``)
  for every family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.distribution import partition as jpart
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.distribution import partition
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs
from repro_torch.models.api import build_model
from repro_torch.models.common import SHAPES
from repro_torch.models.convert import _ref_key, flatten_by_layout, param_shapes

TP_RULES = {"dp": ("data",), "tp": "model", "sp": "model", "ep": "model"}


class FakeMesh:
    """Axis names and sizes only, as both packages' partition functions read
    a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


MESH44 = FakeMesh((4, 4), ("data", "model"))
MESHES = {"4x4": (MESH44, False), "2x16x16": (FakeMesh((2, 16, 16), ("pod", "data", "model")),
                                              True)}


@pytest.fixture(autouse=True)
def rules():
    for pkg in (jpart, partition):
        pkg.set_axis_rules(dict(TP_RULES))
        pkg.set_mesh_sizes({"data": 4, "model": 4})
    yield
    for pkg in (jpart, partition):
        pkg.set_axis_rules(None)
        pkg.set_mesh_sizes(None)


def _set_rules(rules):
    jpart.set_axis_rules(rules)
    partition.set_axis_rules(dict(rules))


def norm(spec):
    """A spec as a tuple, a one-axis tuple entry taken as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def flat(tree, prefix=()):
    """{path: leaf} of nested dicts and tuples (specs are leaves)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key], prefix + (key,)).items()}
    if isinstance(tree, tuple) and not isinstance(tree, (JP, partition.P)):
        return {k: v for i, t in enumerate(tree) for k, v in flat(t, prefix + (i,)).items()}
    return {prefix: tree}


def same_specs(got, want):
    g, w = flat(got), flat(want)
    assert set(g) == set(w), set(g) ^ set(w)
    bad = {k: (g[k], w[k]) for k in w if norm(g[k]) != norm(w[k])}
    assert not bad, bad


def both(shape_tree_fn):
    """The same tree of shapes as the reference's ShapeDtypeStructs and the
    port's meta tensors."""
    return (shape_tree_fn(lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)),
            shape_tree_fn(lambda *s: torch.empty(s, device="meta")))


# ------------------------------------------------------------------ #
# tests/test_partition.py, through both packages
# ------------------------------------------------------------------ #
def test_param_rules():
    def tree(sds):
        return {
            "embed": sds(128, 64),
            "lm_head": sds(64, 128),
            "layers": {
                "attn": {"wq": sds(8, 64, 64), "wo": sds(8, 64, 64)},
                "mlp": {"w1": sds(8, 64, 256), "w2": sds(8, 256, 64)},
                "moe": {"w1": sds(8, 16, 64, 32), "router": sds(8, 64, 16)},
                "ln1": sds(8, 64),
            },
        }
    jt, tt = both(tree)
    got = partition.param_specs(tt, MESH44)
    same_specs(got, jpart.param_specs(jt, MESH44))
    assert got["embed"] == partition.P(None, "model")
    assert got["layers"]["attn"]["wo"] == partition.P(None, "model", None)
    assert got["layers"]["moe"]["w1"] == partition.P(None, "model", None, None)
    assert got["layers"]["moe"]["router"] == partition.P(None, None, None)
    assert got["layers"]["ln1"] == partition.P(None, None)


def test_param_rules_drop_nondivisible():
    jt, tt = both(lambda sds: {"attn": {"wq": sds(4, 64, 30)}})  # 30 % 4 != 0
    got = partition.param_specs(tt, MESH44)
    same_specs(got, jpart.param_specs(jt, MESH44))
    assert got["attn"]["wq"] == partition.P(None, None, None)


def test_zero_specs_extend_and_idempotent():
    jt, tt = both(lambda sds: {"mlp": {"w1": sds(8, 64, 256)}, "ln": sds(7)})
    z1 = partition.zero_specs(partition.param_specs(tt, MESH44), tt, MESH44)
    jz1 = jpart.zero_specs(jpart.param_specs(jt, MESH44), jt, MESH44)
    same_specs(z1, jz1)
    assert norm(z1["mlp"]["w1"]) == ("data", None, "model")
    assert z1["ln"] == partition.P(None)  # 7 not divisible: stays replicated
    assert partition.zero_specs(z1, tt, MESH44) == z1  # idempotent


def test_resolve_spec_shift_right():
    # kv-heads (2) below tp degree (4) -> tp shifts to head_dim (8)
    for shape, logical in (((6, 8, 100, 2, 8), (None, "dp", None, "tp", None)),
                           ((5, 3), ("dp", "tp"))):
        got = partition.resolve_spec(shape, logical, MESH44)
        assert norm(got) == norm(jpart.resolve_spec(shape, logical, MESH44))
    assert norm(partition.resolve_spec((6, 8, 100, 2, 8), (None, "dp", None, "tp", None),
                                       MESH44)) == (None, "data", None, None, "model")
    assert partition.resolve_spec((5, 3), ("dp", "tp"), MESH44) == partition.P(None, None)


def test_shard_divisibility_aware():
    """The reference's ``shard`` is a sharding constraint, which changes no
    value; the port's returns its input."""
    mesh = meshlib.make_mesh((1,), ("model",), device="cpu")
    assert mesh.axis_names == ("model",) and mesh.devices.shape == (1,)
    partition.set_axis_rules({"tp": "model", "dp": None})
    partition.set_mesh_sizes({"model": 1})
    x = torch.zeros((4, 6))
    assert partition.shard(x, "dp", "tp") is x


def test_no_rules_noop():
    partition.set_axis_rules(None)
    x = torch.ones((3, 3))
    assert partition.shard(x, "dp", "tp") is x


# ------------------------------------------------------------------ #
# the ten configs' trees
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in registry.ARCH_IDS:
        jm = jax_build_model(jreg.get_smoke_config(arch))
        tm = build_model(registry.get_smoke_config(arch), device="meta")
        out[arch] = (jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0)), tm)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_and_zero_specs_equal_the_reference(models, arch, mesh_name):
    mesh, multi_pod = MESHES[mesh_name]
    _set_rules(jmesh.axis_rules(multi_pod))
    jm, jshapes, tm = models[arch]
    tshapes = param_shapes(tm)
    jps, tps = jpart.param_specs(jshapes, mesh), partition.param_specs(tshapes, mesh)
    same_specs(tps, jps)
    tz = partition.zero_specs(tps, tshapes, mesh)
    same_specs(tz, jpart.zero_specs(jps, jshapes, mesh))
    assert partition.zero_specs(tz, tshapes, mesh) == tz
    # each port parameter's stacked leaf (``_ref_key``, which the hybrid
    # step reads its ZeRO spec through): one dim a stacked index
    jflat, stacked = flat(jpart.zero_specs(jps, jshapes, mesh)), flat(tshapes)
    for name, p in tm.named_parameters():
        key, index = _ref_key(name)
        shape = tuple(stacked[key].shape)
        assert shape[len(index):] == tuple(p.shape), name
        assert all(0 <= i < n for i, n in zip(index, shape)), name
        assert len(jflat[key]) == p.ndim + len(index), name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(models, arch, mesh_name):
    mesh, multi_pod = MESHES[mesh_name]
    _set_rules(jmesh.axis_rules(multi_pod))
    jcfg, tcfg = jreg.get_smoke_config(arch), registry.get_smoke_config(arch)
    for shape_name, shape in SHAPES.items():
        got = partition.resolve_spec_tree(specs.input_specs(tcfg, shape),
                                          specs.batch_logical(tcfg, shape), mesh)
        want = jpart.resolve_spec_tree(jspecs.input_specs(jcfg, shape),
                                       jspecs.batch_logical(jcfg, shape), mesh)
        same_specs(got, want)
    jm, _, tm = models[arch]
    for b, s in ((128, 32_768), (8, 64), (6, 100)):
        got = partition.resolve_spec_tree(tm.cache_shape(b, s), tm.cache_logical(), mesh)
        want = jpart.resolve_spec_tree(jm.cache_shape(b, s), jm.cache_logical(), mesh)
        layout = getattr(tm, "CACHE_TREE", None)
        same_specs(got, want if layout is None else flatten_by_layout(layout, want))
