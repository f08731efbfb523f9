"""The port stands alone: importing every ``repro_torch`` module loads no
``jax``, ``repro`` or ``homunculus`` module, and its CUDA entry points
raise instead of moving to the CPU when no GPU exists."""

import os
import subprocess
import sys

import numpy as np
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
        "repro_torch.telemetry.flow_health",
        "repro_torch.models.transformer", "repro_torch.serve.engine",
        "repro_torch.kernels.flash_attention", "repro_torch.models.ssm",
        "repro_torch.models.moe", "repro_torch.kernels.selective_scan",
        "repro_torch.configs.jamba_1_5_large_398b",
        "repro_torch.kernels.binarized_gemm", "repro_torch.core.mlalgos",
        "repro_torch.core.designspace", "repro_torch.core.surrogate",
        "repro_torch.core.bo", "repro_torch.core.traincache",
        "repro_torch.core.feasibility", "repro_torch.core.codegen",
        "repro_torch.core.dse", "repro_torch.facade",
        "repro_torch.flowstate.drift", "repro_torch.serve.online",
        "repro_torch.core.fusion", "repro_torch.serve.sharded",
        "repro_torch.configs.moonshot_v1_16b_a3b",
        "repro_torch.configs.mixtral_8x7b", "repro_torch.models.xlstm",
        "repro_torch.configs.llama_3_2_vision_11b",
        "repro_torch.configs.seamless_m4t_large_v2",
        "repro_torch.configs.xlstm_1_3b", "repro_torch.common.pytree",
        "repro_torch.data.tokens", "repro_torch.train.losses",
        "repro_torch.train.step", "repro_torch.optim.optimizers",
        "repro_torch.optim.schedule", "repro_torch.ckpt.checkpoint",
        "repro_torch.ft.restart", "repro_torch.kernels.selective_scan.ops",
        "repro_torch.kernels.selective_scan.ref",
        "repro_torch.launch.train", "repro_torch.launch.serve",
        "repro_torch.launch.specs", "repro_torch.launch.mesh",
        "repro_torch.launch.multihost", "repro_torch.dist.sharding",
        "repro_torch.dist.compression",
        "repro_torch.dist.pipeline"} <= set(names), names
import repro_torch.kernels.selective_scan as ss
assert {"SelectiveScanFn", "selective_scan_bwd_launch", "bwd_chunk",
        "selective_scan_bwd_ref", "selective_scan_bwd_chunked_ref",
        "scan_checkpoints"} <= set(dir(ss))
import repro_torch.kernels._ext as ext
assert "selective_scan_bwd" in ext.LAUNCHES
assert any(str(s).endswith("selective_scan_bwd.cu") for s in ext.SOURCES)
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
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_launch,
    )
    from repro_torch.kernels.selective_scan import (
        selective_scan,
        selective_scan_launch,
    )
    from repro_torch.models.registry import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.packet_engine import PacketServeEngine
    from repro_torch.serve.sharded import ShardedPacketServeEngine
    from repro_torch.serve.steps import init_cache

    cfg = get_smoke_config("qwen3-1.7b")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    stages, _ = traffic.flow_feature_stages(n_slots=64)
    for make in (
        lambda: StatefulPipeline(list(stages), backend="cuda"),
        lambda: StatefulPipeline(list(stages)),
        lambda: init_state(stages[1].spec),
        lambda: PacketServeEngine(
            StatefulPipeline(list(stages), device="cpu"), feature_dim=4),
        lambda: ShardedPacketServeEngine(
            StatefulPipeline(list(stages), device="cpu"), feature_dim=4),
        lambda: stageir.compile_stages([stageir.Reduce("argmax")]),
        lambda: chaining.compile_dag(Model("a") > Model("b"), {}),
        lambda: ServeEngine(cfg, params),
        lambda: init_cache(cfg, 1, 8),
        lambda: init_params(cfg, generator=torch.Generator()),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    # K7 on tensors made for the default device "cuda": torch refuses to
    # make them; on CPU tensors the launch wrapper refuses, never falling
    # back to the plain version
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        flash_attention(*[torch.zeros(1, 4, 2, 16, device="cuda")] * 3)
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_launch(q, q, q, causal=True, window=0, q_offset=0,
                               skv=4)
    # K8 the same way; and the hybrid engine raises like the dense one
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        selective_scan(torch.zeros(1, 2, 4, 8, device="cuda"),
                       torch.zeros(1, 2, 4, 8, device="cuda"),
                       torch.zeros(1, 2, 8, device="cuda"),
                       torch.zeros(1, 4, 8, device="cuda"))
    a = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_launch(a, a, torch.zeros(1, 2, 8), torch.zeros(1, 4, 8))
    hybrid = get_smoke_config("jamba-1.5-large-398b")
    hparams = init_params(hybrid, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    for make in (lambda: ServeEngine(hybrid, hparams),
                 lambda: init_cache(hybrid, 1, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_compiler_entry_points_raise_without_a_gpu():
    """The compiler trains and serves on the card by default: without a
    GPU its entry points raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be shown")
    from repro_torch import facade
    from repro_torch.core import codegen, dse, mlalgos
    from repro_torch.core.alchemy import Model, Platforms
    from repro_torch.core.feasibility import FeasibilityReport
    from repro_torch.data import netdata
    from repro_torch.kernels.binarized_gemm import (
        binarized_gemm,
        binarized_gemm_launch,
    )

    d = netdata.make_ad_dataset(features=7, n_train=256, n_test=64)
    platform = Platforms.Taurus()
    platform.schedule(Model({"name": "m", "algorithm": ["dnn"],
                             "data_loader": lambda: d}))
    svm = mlalgos.train_svm(d, epochs=1)
    rep = FeasibilityReport(True, [], {}, 1.0, 1e9)
    for make in (
        lambda: facade.generate(platform, budget=2, n_init=1),
        lambda: dse.retrain_model(platform, d, algorithms=["svm"],
                                  budget=2),
        lambda: mlalgos.train_dnn(d, hidden=[4], epochs=1),
        lambda: codegen.taurus_codegen("m", svm, rep),
        lambda: mlalgos.dnn_model([{"w": np.zeros((7, 2), np.float32),
                                    "b": np.zeros(2, np.float32)}],
                                  [7, 2], 2, {}),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        binarized_gemm(torch.zeros(2, 3, device="cuda"),
                       torch.zeros(3, 4, device="cuda"))
    with pytest.raises(ValueError, match="CUDA"):
        binarized_gemm_launch(torch.zeros(2, 3), torch.zeros(3, 4))


def test_training_entry_points_raise_without_a_gpu():
    """Training starts on the card by default: without a GPU the state
    refuses to be made there, and K7b's wrapper refuses CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be shown")
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention_bwd_launch
    from repro_torch.train import init_train_state

    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(cfg, generator=torch.Generator())
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_launch(q, q, q, q, causal=True, window=0,
                                   q_offset=0, skv=4)


def test_hybrid_training_entry_points_raise_without_a_gpu():
    """Hybrid training starts on the card by default too: the state with
    an expert share refuses to be made there, and K8b's wrapper and K8's
    checkpointing launch refuse CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be shown")
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.selective_scan import (
        selective_scan_bwd_launch,
        selective_scan_discretized_launch,
    )
    from repro_torch.train import init_train_state

    cfg = get_smoke_config("jamba-1.5-large-398b")
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(cfg, generator=torch.Generator(), experts=range(2))
    B, S, di, N = 1, 4, 8, 4
    dt, x, dy = (torch.ones(B, S, di) for _ in range(3))
    A, BC = -torch.ones(di, N), torch.ones(B, S, N)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_discretized_launch(dt, A, BC, BC, x,
                                          torch.zeros(B, di, N),
                                          checkpoint=True)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_bwd_launch(dt, A, BC, BC, x,
                                  torch.zeros(B, 1, di, N), dy)


def test_launchers_raise_without_a_gpu():
    """The launchers run on the card by default: without a GPU they raise
    before building anything, naming ``--device cpu``'s way out."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be shown")
    from repro_torch.launch import serve, train

    for main in (train.main, serve.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--steps", "1"] if main is train.main else [])
