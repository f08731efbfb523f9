"""The ParamDef trees (``common.pytree``, ``models.registry``) and
``launch.specs`` against the JAX package's: ``input_specs`` of every
architecture at full width and every applicable shape allocates nothing
(every leaf on torch's meta device) and holds the reference's element
count and bytes per dtype under each top-level key (Jamba's Adafactor
state included: a stacked [n, d] leaf's second moment factored as the
reference's); the batch and index
leaves are the reference's exactly; the per-layer parameter axes are the
reference's stacked ones without the layer axis; ``applicable_shapes``
is the reference's; and ``init_params`` draws the same bits as before
the registry's leaves became ParamDefs (crc32 per smoke config)."""

import collections
import zlib

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.common import pytree as jpt
from repro.configs import applicable_shapes as jax_applicable
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import specs as jax_specs
from repro.models import registry as jax_registry
from repro_torch.common import pytree as pt
from repro_torch.configs import (
    applicable_shapes,
    get_config,
    get_smoke_config,
    list_archs,
)
from repro_torch.launch.specs import input_specs, state_defs_for
from repro_torch.models import registry

ARCHS = list_archs()

# crc32 over every leaf's bytes, in tree order, of init_params(generator=
# torch.Generator().manual_seed(0), device="cpu"), taken on the tree whose
# registry returned (shape, dtype, init) tuples
INIT_CRC32 = {
    "jamba-1.5-large-398b": 4263719360,
    "llama-3.2-vision-11b": 1625018240,
    "mixtral-8x7b": 3223914985,
    "moonshot-v1-16b-a3b": 3899876038,
    "qwen1.5-32b": 1596747243,
    "qwen2-7b": 2845187941,
    "qwen3-1.7b": 547949774,
    "seamless-m4t-large-v2": 1039401729,
    "starcoder2-15b": 2187845455,
    "xlstm-1.3b": 2288727775,
}


def _dtype_name(dt) -> str:
    return (str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
            else jnp.dtype(dt).name)


def _totals(leaves) -> dict:
    """{dtype name: (elements, bytes)} over the leaves."""
    out = collections.defaultdict(lambda: [0, 0])
    for x in leaves:
        n, name = 1, _dtype_name(x.dtype)
        for s in x.shape:
            n *= s
        out[name][0] += n
        out[name][1] += n * (x.dtype.itemsize if isinstance(
            x.dtype, torch.dtype) else jnp.dtype(x.dtype).itemsize)
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_allocate_nothing_and_hold_the_references_totals(name):
    cfg, jcfg = get_config(name), jax_config(name)
    assert applicable_shapes(cfg) == jax_applicable(jcfg)
    assert applicable_shapes(get_smoke_config(name)) == jax_applicable(
        jax_smoke(name))
    for shape in applicable_shapes(cfg):
        got, want = input_specs(cfg, shape), jax_specs.input_specs(jcfg,
                                                                   shape)
        assert set(got) == set(want), shape
        for key in got:
            leaves = pt.tree_leaves(got[key])
            assert all(x.device.type == "meta" for x in leaves)
            assert _totals(leaves) == _totals(jax.tree.leaves(
                want[key])), (shape, key)
        jbatch = want.get("batch", {})
        assert {k: (tuple(v.shape), _dtype_name(v.dtype))
                for k, v in got["batch"].items()} == {
            k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in jbatch.items()}, shape
        if "index" in want:
            assert (tuple(got["index"].shape),
                    _dtype_name(got["index"].dtype)) == (
                tuple(want["index"].shape), _dtype_name(want["index"].dtype))
        defs, jdefs = state_defs_for(cfg, shape), jax_specs.state_defs_for(
            jcfg, shape)
        assert {k: v.axes for k, v in defs["batch"].items()} == {
            k: tuple(v.axes) for k, v in jdefs["batch"].items()}


def _axes_by_leaf(tree, stacked: bool) -> dict:
    """{leaf path under a slot: axes} of a ParamDef tree; a stacked
    (reference) leaf loses its leading layer axis."""
    out = {}
    for path, d in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: jpt.is_def(x) or pt.is_def(x))[0]:
        keys = tuple(getattr(p, "key", getattr(p, "idx", None))
                     for p in path)
        out[keys] = tuple(d.axes[1:] if stacked else d.axes)
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_param_and_cache_axes_are_the_references(name):
    cfg, jcfg = get_smoke_config(name), jax_smoke(name)
    defs, jdefs = registry.param_defs(cfg), jax_registry.param_defs(jcfg)
    for key in ("embed", "final_norm"):
        assert _axes_by_leaf(defs[key], False) == _axes_by_leaf(
            jdefs[key], False)
    for stack, jstack in (("slots", "decoder"), ("encoder_slots", "encoder")):
        if jstack not in jdefs:
            continue
        for i, slot in enumerate(defs[stack]):
            assert _axes_by_leaf(slot, False) == _axes_by_leaf(
                jdefs[jstack][f"slot{i}"], True), (stack, i)
    assert _axes_by_leaf(registry.cache_defs(cfg, 3, 20), False) == \
        _axes_by_leaf(jax_registry.cache_defs(jcfg, 3, 20), False)
    assert pt.param_count(registry.layer_defs(cfg)) == registry.param_count(
        cfg) == jax_registry.param_count(jcfg)


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_draws_the_same_bits(name):
    params = registry.init_params(
        get_smoke_config(name), generator=torch.Generator().manual_seed(0),
        device="cpu")
    crc = 0
    for x in pt.tree_leaves(params):
        t = x.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        crc = zlib.crc32(t.numpy().tobytes(), crc)
    assert crc == INIT_CRC32[name]


def test_paramdef_trees_materialize_abstract_and_resolve():
    defs = {"w": pt.ParamDef((4, 6), torch.bfloat16, ("fsdp", "tp"),
                             "scaled"),
            "b": [pt.ParamDef((6,), torch.float32, ("tp",), "zeros"),
                  pt.ParamDef((), torch.int32, (), "ones")]}
    with pytest.raises(ValueError, match="rank"):
        pt.ParamDef((2, 3), torch.float32, ("tp",))
    real = pt.materialize(defs, torch.Generator().manual_seed(1))
    assert real["w"].dtype == torch.bfloat16 and real["w"].shape == (4, 6)
    assert not real["b"][0].any() and int(real["b"][1]) == 1
    again = pt.materialize(defs, torch.Generator().manual_seed(1))
    assert torch.equal(real["w"], again["w"])
    meta = pt.abstract(defs)
    assert meta["w"].device.type == "meta" and meta["b"][1].dtype == \
        torch.int32
    assert pt.param_count(defs) == pt.param_count(real) == 24 + 6 + 1
    assert pt.param_bytes(defs) == pt.param_bytes(real) == 48 + 24 + 4
    assert pt.pspec_tree(defs, lambda axes: axes)["b"][0] == ("tp",)
    assert pt.is_def(defs["w"]) and not pt.is_def(real["w"])
