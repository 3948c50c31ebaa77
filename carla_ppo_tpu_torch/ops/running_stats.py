"""Running statistics + VecNormalize-style reward scaling (port of
carla_ppo_tpu/ops/running_stats.py): per-env discounted return carry,
running variance by batched moment merging, rewards scaled by
1 / sqrt(var + eps) and clipped."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import Tensor


@dataclasses.dataclass
class RunningMoments:
    mean: Tensor  # [] float32
    var: Tensor
    count: Tensor

    @classmethod
    def create(cls, device="cpu") -> "RunningMoments":
        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(mean=f(0.0), var=f(1.0), count=f(1e-4))


def update_moments(m: RunningMoments, batch: Tensor) -> RunningMoments:
    batch = batch.reshape(-1)
    b_count = float(batch.numel())
    b_mean = batch.mean()
    b_var = batch.var(correction=0)
    delta = b_mean - m.mean
    tot = m.count + b_count
    new_mean = m.mean + delta * b_count / tot
    new_var = (m.var * m.count + b_var * b_count + delta**2 * m.count * b_count / tot) / tot
    return RunningMoments(mean=new_mean, var=new_var, count=tot)


def normalize_rewards(
    moments: RunningMoments,
    returns: Tensor,  # [B]
    rewards: Tensor,  # [T, B]
    dones: Tensor,  # [T, B]
    gamma: float,
    clip: float = 10.0,
    eps: float = 1e-8,
) -> Tuple[Tensor, RunningMoments, Tensor]:
    """(normalised rewards [T, B], new moments, new per-env return carry)."""
    d = dones.to(rewards.dtype)
    rets = torch.empty_like(rewards)
    ret = returns
    for t in range(rewards.shape[0]):
        ret = ret * gamma + rewards[t]
        rets[t] = ret
        ret = ret * (1.0 - d[t])
    moments = update_moments(moments, rets)
    scale = 1.0 / torch.sqrt(moments.var + eps)
    return torch.clamp(rewards * scale, -clip, clip), moments, ret
