"""Device resolution shared by every entry point of the port.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``).  A host without a card raises instead of quietly
running the plain-torch twins on the CPU: the port's speed is the card's,
and a silent fallback would hide a misconfigured deployment.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA card (raises without one); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain-torch twins on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
