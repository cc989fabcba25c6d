"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and raise when no GPU is present: they
never fall back to the CPU on their own. The CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU "
            "with the kernels' plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
