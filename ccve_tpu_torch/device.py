"""The device check of the port's public constructors.

A module of its own with no imports from the package, so that every layer
(chunks, tuners, tables, executors) can validate a device argument without
depending on the ops layer."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no GPU is
    present: nothing falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: run on a machine with a GPU, or ask for the "
            "plain CPU path explicitly (device='cpu')"
        )
    return device
