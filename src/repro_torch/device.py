"""The port's one device rule: ``"cuda"`` unless the caller says otherwise,
and no quiet move to the CPU when no GPU exists."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """-> a ``torch.device`` (CUDA with its index); raises when CUDA is
    asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report an indexed device; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
