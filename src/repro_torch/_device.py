"""Device choice shared by every entry point of the port.

An entry point runs on the CUDA card unless the caller passes
``device="cpu"`` (as the CPU tests do).  With no card and no explicit
device it raises: the port never quietly runs on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["device_name", "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           "available")
    return dev


def device_name(device: Union[str, torch.device]) -> str:
    """The card's name (``torch.cuda.get_device_name``) or ``"cpu"``."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
