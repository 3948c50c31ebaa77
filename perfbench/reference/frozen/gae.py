# Frozen copy of carla_ppo_tpu_torch/ops/gae.py (commit cbdb1fb), the benchmark's
# reference: imports made local.
# It imports nothing of the program and is not edited when the program changes.
"""Generalized Advantage Estimation (port of carla_ppo_tpu/ops/gae.py).

Rollouts are continuing (auto-reset), so terminals mask both the bootstrap
and the advantage carry:  A_t = delta_t + gamma * lam * (1 - done_t) * A_{t+1}.
Two forms, as in the JAX package: `compute_gae`, a reverse loop over time
vectorised over envs (T steps), and `compute_gae_associative`, a
log-depth reverse scan over the recurrence's (a, delta) pairs.
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


def compute_gae_associative(rewards: Tensor, values: Tensor, bootstrap_value: Tensor,
                            dones: Tensor, gamma: float = 0.99, lam: float = 0.95) -> Tensor:
    """The same advantages in ceil(log2 T) steps: A_t = b_t + a_t * A_{t+1}
    with a_t = gamma * lam * (1 - done_t) and b_t = delta_t. After the step
    with offset d, (a_t, b_t) maps A_{t+2d} to A_t (Hillis-Steele, from the
    end); a suffix that runs past T meets A_T = 0 and keeps its b."""
    deltas = temporal_deltas(rewards, values, bootstrap_value, dones, gamma)
    a = gamma * lam * (1.0 - dones.to(rewards.dtype))
    b = deltas
    d, T = 1, deltas.shape[0]
    while d < T:
        b = torch.cat([b[:-d] + a[:-d] * b[d:], b[-d:]])
        a = torch.cat([a[:-d] * a[d:], a[-d:]])
        d *= 2
    return b


def normalize_advantages(advantages: Tensor, eps: float = 1e-8) -> Tensor:
    """(A - mean) / (std + eps), population std as jnp.std."""
    return (advantages - advantages.mean()) / (advantages.std(correction=0) + eps)
