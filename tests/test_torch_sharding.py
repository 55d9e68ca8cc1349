"""The port's sharding rules and meshes against the JAX package's, on the
CPU.

- The seven cases of tests/test_sharding.py on the port
  (`repro_torch.sharding`, `repro_torch.launch.mesh`). The reference's
  `test_constrain_inside_context` fails on this jax (its 1x1 mesh has
  Explicit axes, which `with_sharding_constraint` refuses); the port's
  case holds what it intends: inside the rules' context `maybe_constrain`
  gives values equal to its input.
- `default_rules` equal to JAX's dict for one pod and two (level 1).
- `ShardingRules.spec` equal to JAX's `PartitionSpec`, leaf for leaf, for
  every config's parameters at full width (shapes from the port's model
  on the meta device, axes the JAX package's own), on the 1x1, 16x16 and
  2x16x16 meshes; the JAX side on device-less `AbstractMesh`es (level 1).
- The production mesh's shapes, and its `RuntimeError` on a machine with
  fewer CUDA devices.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS, reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.sharding import ShardingRules as JaxRules
from repro.sharding import default_rules as jax_default_rules
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     make_stacked_mesh)
from repro_torch.models import get_model
from repro_torch.sharding import (PartitionSpec as P, ShardingRules,
                                  active_rules, default_rules,
                                  maybe_constrain)

MESHES = {"1x1": ((1, 1), ("data", "model"), False),
          "pod16x16": ((16, 16), ("data", "model"), False),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def rules1x1():
    return ShardingRules(make_local_mesh("cpu"), default_rules(False))


# ------------------------------------------- tests/test_sharding.py's cases

def test_spec_basic(rules1x1):
    # 1x1 mesh: everything maps but to trivial axes
    s = rules1x1.spec(("batch", "seq", "embed"), (8, 16, 32))
    assert s == P("data", None, None)


def test_spec_divisibility_drop(rules1x1):
    # weights: vocab -> model (TP), embed -> data (FSDP at rest)
    s = rules1x1.spec(("vocab", "embed"), (7, 4))
    assert s == P("model", "data")  # 7 % 1 == 0 on the local mesh


def test_spec_unknown_axis(rules1x1):
    s = rules1x1.spec(("nonexistent", None), (4, 4))
    assert s == P(None, None)


def test_no_axis_reuse(rules1x1):
    # two dims both wanting "model": second one must drop
    s = rules1x1.spec(("vocab", "ffn"), (16, 16))
    assert s == P("model", None)


def test_maybe_constrain_noop_outside_context():
    x = torch.ones((4, 4))
    y = maybe_constrain(x, ("batch", None))
    assert y is x


def test_constrain_inside_context(rules1x1):
    x = torch.ones((4, 4))
    with active_rules(rules1x1):
        y = maybe_constrain(x, ("batch", None))
        with pytest.raises(ValueError):
            maybe_constrain(x, ("batch",))     # one axis for two dims
    assert torch.equal(x, y)


def test_tree_shardings(rules1x1):
    shapes = dict(w=torch.empty((8, 4), device="meta"),
                  b=torch.empty((4,), device="meta"))
    axes = dict(w=("embed", "ffn"), b=("ffn",))
    sh = rules1x1.tree_specs(shapes, axes)
    # weights: embed dim FSDP-sharded over data, ffn TP-sharded over model
    assert sh["w"] == P("data", "model")
    assert sh["b"] == P("model")


# ------------------------------------------------------ against JAX's rules

@pytest.mark.parametrize("multi_pod", [False, True])
def test_default_rules_match_jax(multi_pod):
    assert default_rules(multi_pod) == jax_default_rules(multi_pod)


def _leaves(shapes, axes, prefix=""):
    """(path, shape, axes) of the port's parameter tree."""
    for k, v in shapes.items():
        if isinstance(v, dict):
            yield from _leaves(v, axes[k], f"{prefix}{k}/")
        else:
            yield prefix + k, v, axes[k]


def _meta_shapes(model):
    """The JAX tree's leaf shapes from the port's (meta) model."""
    from repro_torch.convert import Stack, lm_param_tree

    def shape(leaf):
        return (leaf.lead + tuple(leaf[0].shape) if isinstance(leaf, Stack)
                else tuple(leaf.shape))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else shape(v)
                for k, v in tree.items()}
    return walk(lm_param_tree(model))


@pytest.fixture(scope="module")
def full_width_leaves():
    """Every config's (path, shape, JAX axes) at full width: the port's
    meta model gives the shapes, the JAX package's reduced init its axes
    (the JAX dry run's `param_axes_of`)."""
    out = {}
    for name in ARCHS:
        jcfg = jax_reduced_config(name)
        _, jaxes = jax_get_model(jcfg).init_params(jcfg,
                                                   jax.random.PRNGKey(0))
        cfg = get_config(name)
        model = get_model(cfg)(cfg, device="meta", seed=None)
        out[name] = list(_leaves(_meta_shapes(model), jaxes))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_matches_jax_for_every_param(mesh, full_width_leaves):
    sizes, names, multi_pod = MESHES[mesh]
    jrules = JaxRules(AbstractMesh(sizes, names), jax_default_rules(
        multi_pod))
    port_mesh = make_stacked_mesh(dict(zip(names, sizes)), "cpu")
    rules = ShardingRules(port_mesh, default_rules(multi_pod))
    checked = 0
    for name, leaves in full_width_leaves.items():
        for path, shape, axes in leaves:
            ref = jrules.spec(axes, shape)
            assert isinstance(ref, JP)
            got = rules.spec(axes, shape)
            assert got == tuple(ref), (name, path, shape, axes, got, ref)
            checked += 1
    assert checked == 191           # every leaf of the ten configs


def test_local_shape():
    rules = ShardingRules(make_production_mesh(multi_pod=True,
                                               abstract=True),
                          default_rules(True))
    spec = rules.spec(("embed", "ffn"), (4096, 1024))
    assert spec == P(("pod", "data"), "model")
    assert rules.local_shape((4096, 1024), spec) == (128, 64)


def test_meshes():
    assert make_production_mesh(abstract=True).shape == {"data": 16,
                                                         "model": 16}
    m = make_production_mesh(multi_pod=True, abstract=True)
    assert tuple(m.shape) == ("pod", "data", "model") and m.size == 512
    assert m.devices is None
    local = make_local_mesh("cpu")
    assert local.shape == {"data": 1, "model": 1}
    assert local.devices == (torch.device("cpu"),)
    assert make_stacked_mesh({"data": 2, "model": 2}, "cpu").stacked


def test_production_mesh_needs_devices():
    have = torch.cuda.device_count()
    if have >= 256:
        pytest.skip("this machine has a production mesh's devices")
    with pytest.raises(RuntimeError, match=f"need 256 devices, have {have}"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match=f"need 512 devices, have {have}"):
        make_production_mesh(multi_pod=True)
