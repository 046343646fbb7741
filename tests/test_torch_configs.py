"""The port's config registry against the JAX package's: the same archs,
cells and long-context set, the same numbers in every full and reduced
config, and the same parameter count for every full config.

The full configs are built without allocating: ``repro``'s under
``jax.eval_shape``, the port's under ``FakeTensorMode`` (shapes and types
only; deepseek-v3-671b alone would take 1.3 TB in bf16).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as J
import repro_torch.configs as T
from repro.models.transformer import init_params as repro_init
from repro_torch.models.transformer import init_params

ARCHS = J.list_archs()


def test_registry_matches_repro():
    assert T.list_archs() == ARCHS and len(ARCHS) == 10
    assert T.cells() == J.cells()
    assert T.LONG_CONTEXT_ARCHS == J.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J.SHAPES.items()}
    assert T.__all__ == J.__all__


def _fields(cfg) -> dict:
    """A config's fields, nested configs included, with dtypes as names and
    the JAX package's ``scan_units`` (the port has no scan) left out."""
    out = {}
    for f in dataclasses.fields(cfg):
        if f.name == "scan_units":
            continue
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif isinstance(v, torch.dtype) or f.name.endswith("dtype"):
            v = str(jnp.dtype(v) if not isinstance(v, torch.dtype)
                    else v).split(".")[-1]
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_repro(arch):
    assert _fields(T.get_config(arch)) == _fields(J.get_config(arch))
    assert _fields(T.get_reduced_config(arch)) == \
        _fields(J.get_reduced_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_count_matches_repro(arch):
    jshapes = jax.eval_shape(lambda k: repro_init(k, J.get_config(arch)),
                             jax.random.PRNGKey(0))
    want = sum(math.prod(a.shape) for a in jax.tree_util.tree_leaves(jshapes))
    with FakeTensorMode():
        params = init_params(torch.Generator().manual_seed(0),
                             T.get_config(arch), device="cpu")
        got = sum(t.numel() for t in pytree.tree_leaves(params))
    assert got == want, (arch, got, want)
