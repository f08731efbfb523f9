"""The port stands alone: importing every ``repro_torch`` module loads no
``jax``, ``repro`` or ``homunculus`` module, and its CUDA entry points
raise instead of moving to the CPU when no GPU exists."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    __import__(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro", "homunculus"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
assert {"repro_torch.core.chaining", "repro_torch.core.alchemy",
        "repro_torch.data.netdata", "repro_torch.telemetry",
        "repro_torch.telemetry.flow_health"} <= set(names), names
"""


def test_port_imports_nothing_of_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_SKIP_COMPAT="1")
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be shown")
    from repro_torch.core import chaining, stageir
    from repro_torch.core.alchemy import Model
    from repro_torch.data import traffic
    from repro_torch.flowstate import StatefulPipeline
    from repro_torch.flowstate.registers import init_state
    from repro_torch.serve.packet_engine import PacketServeEngine

    stages, _ = traffic.flow_feature_stages(n_slots=64)
    for make in (
        lambda: StatefulPipeline(list(stages), backend="cuda"),
        lambda: StatefulPipeline(list(stages)),
        lambda: init_state(stages[1].spec),
        lambda: PacketServeEngine(
            StatefulPipeline(list(stages), device="cpu"), feature_dim=4),
        lambda: stageir.compile_stages([stageir.Reduce("argmax")]),
        lambda: chaining.compile_dag(Model("a") > Model("b"), {}),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
