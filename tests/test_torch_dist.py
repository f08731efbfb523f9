"""The distribution layer (``repro_torch.dist``, ``launch.mesh``,
``launch.multihost``) against the JAX package's: the axis rules and the
shape fitting on the reference tests' inputs (and a hypothesis property
against the reference's results), int8 compression bit for bit, the
cluster environment forms; then one subprocess running a 4-rank gloo
group for the collectives (``tools/dist_check.py``): ``compressed_psum``
bit for bit the rank-ordered sum of every rank's ``roundtrip`` and
within the reference test's relative 0.05 of ``all_reduce``,
``pipeline_apply`` (P = 4, M = 8) within the reference test's 1e-5 of
the sequential chain, and ``shard`` on a 2 x 2 mesh."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.dist import compression as jax_compression
from repro.dist.sharding import AxisRules as JaxRules
from repro.dist.sharding import DECODE_RULES as JAX_DECODE
from repro.dist.sharding import DEFAULT_RULES as JAX_DEFAULT
from repro.dist.sharding import PREFILL_RULES as JAX_PREFILL
from repro.launch.mesh import fit_pspec as jax_fit_pspec
from repro_torch.dist import compression
from repro_torch.dist.sharding import (
    DECODE_RULES,
    DEFAULT_RULES,
    PREFILL_RULES,
    AxisRules,
    axis_size,
    current_mesh,
    mesh_context,
    shard,
)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.multihost import (
    HostInfo,
    detect_cluster,
    host_batch_slice,
)

HSET = settings(max_examples=25, deadline=None)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("rules,jrules,mesh,logical", [
    (DEFAULT_RULES, JAX_DEFAULT, {"data": 16, "model": 16},
     ("batch", None, "tp")),
    (DEFAULT_RULES, JAX_DEFAULT, {"pod": 2, "data": 16, "model": 16},
     ("batch",)),
    (DEFAULT_RULES, JAX_DEFAULT, {"data": 4}, ("batch", "tp")),
    (AxisRules({"a": "model", "b": "model"}),
     JaxRules({"a": "model", "b": "model"}), {"model": 4}, ("a", "b")),
    (PREFILL_RULES, JAX_PREFILL, {"data": 2, "model": 8},
     ("batch", "sp", "tp", None)),
    (DECODE_RULES, JAX_DECODE, {"pod": 2, "data": 2, "model": 8},
     ("batch", "fsdp", "vocab", "unknown")),
])
def test_rules_resolve_as_the_reference(rules, jrules, mesh, logical):
    got = rules.resolve(logical, _FakeMesh(mesh))
    assert tuple(got) == tuple(jrules.resolve(logical, _FakeMesh(mesh)))
    assert rules.table == jrules.table


def test_rules_known_answers_and_the_context():
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert tuple(DEFAULT_RULES.resolve(("batch",), mesh)) == (
        ("pod", "data"),)
    assert tuple(DEFAULT_RULES.resolve(("batch", "tp"), _FakeMesh(
        {"data": 4}))) == ("data",)
    x = torch.ones(3)
    assert current_mesh() is None and shard(x, "batch") is x
    assert axis_size("batch") == 1
    with mesh_context(mesh):
        assert current_mesh() is mesh
        assert axis_size("batch") == 32 and axis_size("sp") == 1
        with pytest.raises(TypeError, match="DeviceMesh"):
            shard(x, "batch")
    assert current_mesh() is None


@given(dims=st.lists(st.integers(1, 64), min_size=1, max_size=4),
       seed=st.integers(0, 100))
@HSET
def test_fit_pspec_always_divisible_and_is_the_references(dims, seed):
    mesh = _FakeMesh({"data": 4, "model": 8})
    rng = np.random.default_rng(seed)
    logical = [rng.choice(["batch", "fsdp", "tp", None]) for _ in dims]
    spec = DEFAULT_RULES.resolve(logical, mesh)
    fitted = tmesh.fit_pspec(tuple(dims), spec, mesh)
    assert tuple(fitted) == tuple(jax_fit_pspec(
        tuple(dims), JAX_DEFAULT.resolve(logical, mesh), mesh))
    for dim, entry in zip(dims, tuple(fitted) + (None,) * len(dims)):
        if entry is None:
            continue
        prod = 1
        for a in ((entry,) if isinstance(entry, str) else entry):
            prod *= mesh.shape[a]
        assert dim % prod == 0


def test_sharding_tree_places_every_def():
    from repro_torch.common.pytree import ParamDef
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeMesh({"data": 2, "model": 4})
    defs = {"wq": ParamDef((8, 6, 4), torch.bfloat16, ("fsdp", "tp", None)),
            "s": ParamDef((), torch.float32, ())}
    tree = tmesh.sharding_tree(defs, mesh)
    # 6 heads on a 4-way model axis: replicated, as fit_pspec says
    assert tree["wq"] == [Shard(0), Replicate()]
    assert tree["s"] == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="needs 256 ranks.*has 1"):
        tmesh.make_production_mesh(device_type="cpu")


# ---------------------------------------------------------- compression


def _compression_inputs():
    rng = np.random.default_rng(0)
    ties = np.zeros(256, np.float32)
    ties[0] = 127.0                      # scale 1: x / scale = x exactly
    ties[1:9] = [0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 3.5]
    return [rng.normal(size=n).astype(np.float32) * s
            for n, s in ((1, 1.0), (300, 1e-3), (1000, 50.0), (4097, 1.0))] \
        + [np.zeros(200, np.float32), ties,
           rng.normal(size=(3, 5, 7)).astype(np.float32)]


@pytest.mark.parametrize("i", range(7))
def test_quantize_and_roundtrip_bit_for_bit(i):
    x = _compression_inputs()[i]
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jax_compression.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    y = compression.dequantize(q, s, x.shape).numpy()
    np.testing.assert_array_equal(
        y.view(np.uint32), np.asarray(jax_compression.dequantize(
            jq, js, x.shape)).view(np.uint32))
    np.testing.assert_array_equal(
        compression.roundtrip(torch.from_numpy(x)).numpy().view(np.uint32),
        np.asarray(jax_compression.roundtrip(jnp.asarray(x))).view(
            np.uint32))


@pytest.mark.parametrize("n,group", [(1, 2), (1_000_000, 2), (12_345, 8)])
def test_wire_bytes_are_the_references(n, group):
    assert compression.wire_bytes(n, group=group) == \
        jax_compression.wire_bytes(n, group=group)


# ------------------------------------------------------------- multi-host


def test_detect_cluster_env_forms(monkeypatch):
    for k in ("REPRO_NUM_PROC", "REPRO_PROC_ID", "REPRO_COORD_ADDR",
              "SLURM_NTASKS", "SLURM_PROCID", "SLURM_NODELIST", "RANK",
              "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert detect_cluster() == HostInfo(0, 1, None)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "h9")
    monkeypatch.setenv("MASTER_PORT", "777")
    assert detect_cluster() == HostInfo(1, 2, "h9:777")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NODELIST", "tpu[0-7]")
    assert detect_cluster() == HostInfo(3, 8, "tpu:12345")
    monkeypatch.setenv("REPRO_NUM_PROC", "4")
    monkeypatch.setenv("REPRO_PROC_ID", "2")
    monkeypatch.setenv("REPRO_COORD_ADDR", "h0:1234")
    info = detect_cluster()
    assert info == HostInfo(2, 4, "h0:1234")
    assert host_batch_slice(256, info) == slice(128, 192)
    with pytest.raises(AssertionError, match="must divide"):
        host_batch_slice(10, info)


# ------------------------------------------- collectives: 4 gloo ranks


def test_collectives_on_four_gloo_ranks():
    """``tools/dist_check.py --device cpu``: 4 gloo ranks, each checking
    ``compressed_psum``, ``pipeline_apply``, ``shard`` on a 2 x 2 mesh and
    ``make_global_batch`` (the tool's docstring lists the bounds); the
    same script runs over NCCL on 4 cards."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "dist_check.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=repo, timeout=120)
    assert out.returncode == 0 and "DIST_CHECK_OK" in out.stdout, (
        out.stdout[-2000:], out.stderr[-4000:])
