"""Where the port's tensor work runs.

Every entry point of the port runs on the CUDA card unless its caller
asks for the CPU. Asking for the card where there is none is an error:
the port never falls back to the CPU on its own.
"""
from __future__ import annotations

import time
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``); anything else is taken as given.
    A CUDA device comes back with its index (``cuda`` → ``cuda:0``), so it
    compares equal to the device of the tensors placed on it.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the "
            "CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def sync_clock(device: torch.device) -> float:
    """The host clock after the device has finished its queued work (a
    CUDA synchronize; nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
