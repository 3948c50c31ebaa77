"""Seeded weights made on the device, the same for the program and the
reference: flax's default kernel init (variance scaling, fan in, a normal
truncated to two standard deviations), zero biases, drawn in one call."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def _fan_in(module: nn.Module) -> int:
    w = module.weight
    if isinstance(module, nn.Linear):
        return w.shape[1]
    if isinstance(module, nn.ConvTranspose2d):  # [in, out, kh, kw]; flax: kh * kw * in
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w.shape[1] * w.shape[2] * w.shape[3]  # Conv2d [out, in, kh, kw]


def seeded_weights(model: nn.Module, seed: int, device: torch.device,
                   scales: Dict[str, float] | None = None) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor on `device`} for every Linear and conv
    weight and bias of `model`; `scales` maps a weight's name to its
    variance scale (1 elsewhere). Other parameters keep the constructor's
    values. The same seed and module tree give the same tensors."""
    scales = scales or {}
    leaves = [(name, mod) for name, mod in model.named_modules()
              if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d))]
    total = sum(mod.weight.numel() for _, mod in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    u = torch.rand(total, generator=gen, device=device)
    normal = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    out, at = {}, 0
    for name, mod in leaves:
        n = mod.weight.numel()
        key = f"{name}.weight" if name else "weight"
        std = math.sqrt(scales.get(key, 1.0) / _fan_in(mod)) / _TRUNC_STD
        out[key] = (normal[at:at + n] * std).view(mod.weight.shape)
        at += n
        if mod.bias is not None:
            out[key[:-len("weight")] + "bias"] = torch.zeros(mod.bias.shape, device=device)
    return out


def load_into(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `model`'s parameters of the same names."""
    params = dict(model.named_parameters())
    missing = set(weights) - set(params)
    if missing:
        raise KeyError(f"no parameter for {sorted(missing)}")
    with torch.no_grad():
        for name, t in weights.items():
            params[name].copy_(t)
