"""Device selection: the card unless the caller asks for the CPU, and no
CPU fallback for CUDA."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device.  A CUDA device requires a visible card
    and raises otherwise; nothing moves to the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" and "cuda:0" name one card: tensors report the indexed form
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
