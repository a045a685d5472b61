"""Device resolution: every entry point of the port runs on the card unless
the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means "cuda" (the current card, with its index). A CUDA
    device without a card raises RuntimeError; nothing falls back to the
    CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (--device "
                "cpu) to run the plain PyTorch path on the CPU")
        if dev.index is None:  # tensors report cuda:N; compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
