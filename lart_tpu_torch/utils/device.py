"""Explicit device resolution: CUDA unless the caller names the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """torch.device for `device` ('cuda' when None).

    Raises when CUDA is asked for and is missing: a run never falls back
    to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'device cuda requested but torch.cuda.is_available() is '
                'False; pass --device cpu to run the plain PyTorch path')
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {dev}')
    return dev
