"""Device resolution and card identification.

The port runs on CUDA unless the CPU is asked for by name: a ``"cuda"``
request on a machine without CUDA raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU.")
    return dev


def card_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
