"""The port's logical-axes trees against the JAX package's, on the CPU.

For each of the ten reduced configs, `LM.param_axes()` equals the second
element of JAX's `init_params(cfg, key)` and `LM.cache_axes(batch,
max_seq)` the second element of JAX's `init_cache(cfg, batch, max_seq)`,
key for key and leaf for leaf (level 1): nested dicts in the tree of
`convert.lm_param_tree`, a leading "layers" on every layer stack (two on
RG-LRU's `groups.rec`). Every axes leaf has one entry a dim of its
tensor.
"""
import jax
import pytest
import torch

from repro.configs import ARCHS, reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import reduced_config
from repro_torch.convert import Stack, lm_param_tree
from repro_torch.models import get_model


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pairs(tree, axes, prefix=""):
    assert sorted(tree) == sorted(axes), (prefix, sorted(tree), sorted(axes))
    for k in tree:
        if isinstance(tree[k], dict):
            yield from _pairs(tree[k], axes[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k], axes[k]


@pytest.mark.parametrize("name", list(ARCHS))
def test_axes_trees_match_jax(name):
    jcfg = jax_reduced_config(name)
    jmodel = jax_get_model(jcfg)
    _, jparam_axes = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    _, jcache_axes = jmodel.init_cache(jcfg, 2, 64)
    cfg = reduced_config(name)
    model = get_model(cfg)(cfg, device="cpu", seed=0)

    assert model.param_axes() == jparam_axes
    assert model.cache_axes(2, 64) == jcache_axes

    for path, leaf, axes in _pairs(lm_param_tree(model),
                                   model.param_axes()):
        ndim = (len(leaf.lead) + leaf[0].ndim if isinstance(leaf, Stack)
                else leaf.ndim)
        assert len(axes) == ndim, (path, axes)
    with torch.inference_mode():
        cache = model.init_cache(2, 64)
    for path, t, axes in _pairs(cache, model.cache_axes(2, 64)):
        assert len(axes) == t.ndim, (path, axes, tuple(t.shape))
