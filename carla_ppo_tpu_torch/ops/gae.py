"""Generalized Advantage Estimation (port of carla_ppo_tpu/ops/gae.py).

Rollouts are continuing (auto-reset), so terminals mask both the bootstrap
and the advantage carry:  A_t = delta_t + gamma * lam * (1 - done_t) * A_{t+1}.
The scan form (a reverse loop over time, vectorised over envs) is ported.
"""

from __future__ import annotations

import torch
from torch import Tensor


def temporal_deltas(rewards: Tensor, values: Tensor, bootstrap_value: Tensor,
                    dones: Tensor, gamma: float) -> Tensor:
    next_values = torch.cat([values[1:], bootstrap_value[None]], 0)
    not_done = 1.0 - dones.to(rewards.dtype)
    return rewards + not_done * gamma * next_values - values


def compute_gae(rewards: Tensor, values: Tensor, bootstrap_value: Tensor, dones: Tensor,
                gamma: float = 0.99, lam: float = 0.95) -> Tensor:
    """GAE advantages, [T, ...] like `rewards`."""
    deltas = temporal_deltas(rewards, values, bootstrap_value, dones, gamma)
    not_done = 1.0 - dones.to(rewards.dtype)
    adv = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * not_done[t] * carry
        adv[t] = carry
    return adv


def normalize_advantages(advantages: Tensor, eps: float = 1e-8) -> Tensor:
    """(A - mean) / (std + eps), population std as jnp.std."""
    return (advantages - advantages.mean()) / (advantages.std(correction=0) + eps)
