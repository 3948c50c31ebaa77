"""Device selection: the port runs on the card unless the caller asks for
the CPU. Nothing falls back silently."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def make_generator(seed: int, device: str | torch.device) -> torch.Generator:
    """A seeded torch.Generator on `device` (never the global RNG)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
