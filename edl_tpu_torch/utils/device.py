"""Device resolution: the card by default, the CPU only when asked.

The counterpart of the JAX package's backend probe.  PyTorch initialises
CUDA lazily and reports a missing card as ``torch.cuda.is_available() ==
False`` instead of hanging, so no subprocess probe is needed: an entry
point resolves its device once, and a missing card is an error unless the
caller passed ``device="cpu"``.
"""

from __future__ import annotations

import subprocess

import torch


class NoCardError(RuntimeError):
    """A CUDA device was asked for (the default) and none is present."""


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.
    Raises :class:`NoCardError` for a CUDA device when there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCardError("no CUDA device is available; pass device='cpu' "
                          "to run on the CPU")
    return dev


def enter_device(device: str | torch.device | None) -> None:
    """Make ``device`` this thread's current CUDA device (a no-op for the
    CPU or None).  The current device is per thread, and a fresh thread
    starts on device 0 with no current context."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))


def smi_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` CSV, one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
