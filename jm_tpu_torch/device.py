"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve(device, who: str) -> torch.device:
    """torch.device(device) for a cuda or cpu request; a CUDA request
    without a card raises RuntimeError (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: CUDA requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
    elif device.type != "cpu":
        raise ValueError(f"{who}: device {device} is neither cuda nor cpu")
    return device
