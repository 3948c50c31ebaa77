# Frozen copy of carla_ppo_tpu_torch/utils/device.py (commit cbdb1fb), the benchmark's
# reference: imports made local.
# It imports nothing of the program and is not edited when the program changes.
"""Device selection: the port runs on the card unless the caller asks for
the CPU. Nothing falls back silently."""

from __future__ import annotations

import hashlib

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


def exact_float32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card:
    TF32 off for both (cuDNN allows it by default), as the JAX package's
    float32 path and the parity tests assume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_generator(seed: int, device: str | torch.device) -> torch.Generator:
    """A seeded torch.Generator on `device` (never the global RNG)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def derived_generator(generator: torch.Generator, salt: str) -> torch.Generator:
    """A new generator on `generator`'s device, seeded from a hash of its
    state and `salt`; `generator` itself draws nothing. The same state and
    salt give the same stream on every process."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes() + salt.encode()).digest()
    return make_generator(int.from_bytes(digest[:8], "little") & (2**63 - 1), generator.device)
