"""Device selection. The port runs on the card unless the caller asks
for the CPU: asking for CUDA where there is none raises, it never
silently picks the CPU."""
from __future__ import annotations

import contextlib
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")


def on_device(device: torch.device):
    """A context in which kernels launch on ``device``'s current stream:
    the current CUDA device for a card, nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
