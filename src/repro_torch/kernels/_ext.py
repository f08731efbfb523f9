"""Build and load the port's CUDA kernels; count their launches.

All ``.cu`` sources go through ONE ``torch.utils.cpp_extension.load``
call at first use.  The ``.cu`` files expose plain C launchers and never
include PyTorch's headers (nvcc compiles them in seconds); only the small
``kernels/csrc/binding.cpp`` includes ``torch/extension.h``.  The build
lands in ``build/torch_kernels/`` at the repository root.

No ``--use_fast_math``: the WindowStats readout divide must stay the IEEE
divide so the readout rows match the reference bit for bit.

A failed build raises.  Nothing here hands over to a plain version.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_REPO = _PKG.parents[2]
BUILD_DIR = _REPO / "build" / "torch_kernels"

SOURCES = (
    _PKG / "csrc" / "binding.cpp",
    _PKG / "flow_update" / "csrc" / "flow_update.cu",
    _PKG / "fused_mlp" / "csrc" / "fused_mlp.cu",
    _PKG / "fused_mlp" / "csrc" / "fused_dag.cu",
    _PKG / "fused_flow" / "csrc" / "fused_flow.cu",
    _PKG / "mat_lut" / "csrc" / "mat_lut.cu",
    _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    _PKG / "flash_attention" / "csrc" / "flash_prefill.cu",
    _PKG / "flash_attention" / "csrc" / "flash_prefill_f32.cu",
    _PKG / "flash_attention" / "csrc" / "flash_decode.cu",
    _PKG / "flash_attention" / "csrc" / "flash_backward.cu",
    _PKG / "selective_scan" / "csrc" / "selective_scan.cu",
    _PKG / "selective_scan" / "csrc" / "selective_scan_bwd.cu",
    _PKG / "binarized_gemm" / "csrc" / "binarized_gemm.cu",
)
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

# launches per kernel wrapper, counted where each wrapper launches its
# kernel and nowhere else (chip_smoke.py reads them around the main path)
LAUNCHES = {"fused_flow_serve": 0, "flow_update": 0, "fused_mlp_classify": 0,
            "mat_lut_classify": 0, "fused_mlp": 0, "fused_dag": 0,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "selective_scan": 0, "selective_scan_discretized": 0,
            "selective_scan_bwd": 0, "binarized_gemm": 0}

_EXT = None
# the online loop builds, launches and counts from a retrain worker while
# the serving thread does the same: one build, and no lost count
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def header_define(name: str) -> int:
    """The integer a ``#define`` of ``csrc/rt_types.h`` gives ``name``, so
    that a limit the kernels are compiled with is written once."""
    for line in (_PKG / "csrc" / "rt_types.h").read_text().splitlines():
        parts = line.split()
        if parts[:2] == ["#define", name]:
            return int(parts[2])
    raise KeyError(f"{name} is not defined in csrc/rt_types.h")


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def refuse_grad(name: str, tensors) -> None:
    """Raises under autograd (grad mode on and an input that requires
    grad): K8's TPU interface (``selective_scan``) and K9 have no backward
    on the card, and a launch's output carries no gradient, so training
    through them would drop it without a word."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward on the card, and none is planned: no "
            "path of the JAX package or of the port trains through it (the "
            "Mamba block trains through K8's discretizing entry, "
            "selective_scan_discretized, whose backward is K8b; no model "
            "of either package calls the binarized product).  Its plain "
            "version on CPU tensors is differentiable")


def extension():
    """The loaded extension module, built on first call (once, whichever
    threads ask)."""
    global _EXT
    if _EXT is None:
        with _BUILD_LOCK:
            if _EXT is None:
                from torch.utils.cpp_extension import load

                os.makedirs(BUILD_DIR, exist_ok=True)
                _EXT = load(
                    name="repro_torch_kernels",
                    sources=[str(s) for s in SOURCES],
                    build_directory=str(BUILD_DIR),
                    extra_include_paths=[str(_PKG / "csrc")],
                    extra_cuda_cflags=list(CUDA_FLAGS),
                    verbose=False,
                )
    return _EXT
