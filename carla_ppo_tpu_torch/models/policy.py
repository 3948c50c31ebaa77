"""Gaussian actor-critic in PyTorch (port of carla_ppo_tpu/models/policy.py).

- policy trunk MLP(500, 300), ReLU after every layer including the last;
- action mean: Dense(num_actions) -> tanh, rescaled to the action box,
  initialised with variance scaling 0.1 (fan_in, truncated normal);
- log-std: a free per-action parameter, log(initial_std);
- value: its own MLP(500, 300) ReLU trunk + Dense(1).

Every other Dense is initialised like flax's default (lecun normal kernel,
zero bias), not like torch.nn.Linear, from the generator passed in.

`compute_dtype` mirrors the JAX module's `dtype`: parameters stay float32;
with bfloat16 every Dense casts its input, kernel and bias to bfloat16 and
rounds the product and the bias add to it (flax `Dense(dtype=bfloat16)`),
the ReLUs and the tanh run in bfloat16, and the action mean, the value and
the Gaussian math come back in float32. `with_compute_dtype` gives a twin
that shares the parameter tensors (the "mixed" recipe's behaviour policy).
"""

from __future__ import annotations

import copy
import math
from typing import Sequence, Tuple

import torch
from torch import Tensor, nn
from torch.nn import functional as F

from carla_ppo_tpu_torch.models.vae import lecun_normal_
from carla_ppo_tpu_torch.utils import profiling

LOG_2PI = math.log(2.0 * math.pi)


def _dense(n_in: int, n_out: int, generator, scale: float = 1.0) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    lecun_normal_(layer.weight, n_in, generator, scale)
    nn.init.zeros_(layer.bias)
    return layer


def linear(layer: nn.Linear, x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """`layer(x)` computed in `dtype`, rounding where flax Dense(dtype=) does:
    after the product and again after the bias add (float32: one call)."""
    if dtype == torch.float32:
        return F.linear(x, layer.weight, layer.bias)
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).t()) + layer.bias.to(dtype)


class MLP(nn.Module):
    def __init__(self, n_in: int, hidden_sizes: Sequence[int], output_activation: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        layers, c = [], n_in
        for h in hidden_sizes:
            layers.append(_dense(c, h, generator))
            c = h
        self.dense = nn.ModuleList(layers)
        self.output_activation = output_activation

    def forward(self, x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        for i, layer in enumerate(self.dense):
            x = linear(layer, x, dtype)
            if i < len(self.dense) - 1 or self.output_activation:
                x = torch.relu(x)
        return x


class ActorCritic(nn.Module):
    """Continuous Gaussian policy + state-value function."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int = 2,
        action_low: Tuple[float, ...] = (-1.0, 0.0),
        action_high: Tuple[float, ...] = (1.0, 1.0),
        pi_hidden_sizes: Tuple[int, ...] = (500, 300),
        vf_hidden_sizes: Tuple[int, ...] | None = (500, 300),
        initial_std: float = 1.0,
        initial_mean_factor: float = 0.1,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_actions = num_actions
        self.compute_dtype = compute_dtype
        self.register_buffer("action_low", torch.tensor(action_low, dtype=torch.float32))
        self.register_buffer("action_high", torch.tensor(action_high, dtype=torch.float32))
        self.pi = MLP(obs_dim, pi_hidden_sizes, generator=generator)
        self.action_mean = _dense(pi_hidden_sizes[-1], num_actions, generator, initial_mean_factor)
        self.action_logstd = nn.Parameter(
            torch.full((num_actions,), math.log(initial_std), dtype=torch.float32)
        )
        self.vf = None if vf_hidden_sizes is None else MLP(obs_dim, vf_hidden_sizes, generator=generator)
        vf_out = pi_hidden_sizes[-1] if vf_hidden_sizes is None else vf_hidden_sizes[-1]
        self.value = _dense(vf_out, 1, generator)

    def forward(self, obs: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(action_mean [B, A], action_std [A], value [B]), float32."""
        dt = self.compute_dtype
        pi = self.pi(obs, dt)
        raw_mean = linear(self.action_mean, pi, dt)
        low, high = self.action_low, self.action_high
        # (tanh + 1) / 2 stays in the compute dtype; the box scale promotes
        # to float32, as jnp promotion does in the JAX module.
        action_mean = low + (torch.tanh(raw_mean) + 1.0) / 2.0 * (high - low)
        vf = pi if self.vf is None else self.vf(obs, dt)
        value = linear(self.value, vf, dt).squeeze(-1)
        return action_mean.to(torch.float32), torch.exp(self.action_logstd), value.to(torch.float32)

    def with_compute_dtype(self, dtype: torch.dtype) -> "ActorCritic":
        """A twin computing in `dtype` on the same parameter tensors (a
        shallow copy: an update of either is seen by both)."""
        twin = copy.copy(self)
        twin.compute_dtype = dtype
        return twin

    def sample(
        self,
        obs: Tensor,
        generator: torch.Generator | None = None,
        greedy: bool = False,
        noise: Tensor | None = None,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """(clipped action, log-prob of the clipped action, value). `noise`
        (standard normal, mean-shaped) replaces the generator's draw."""
        with profiling.span("policy.sample"):
            return self.sample_from(self(obs), generator, greedy, noise)

    def sample_from(
        self,
        mean_std_value: Tuple[Tensor, Tensor, Tensor],
        generator: torch.Generator | None = None,
        greedy: bool = False,
        noise: Tensor | None = None,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """`sample` from this policy's forward output (mean, std, value)."""
        mean, std, value = mean_std_value
        if greedy:
            action = mean
        else:
            if noise is None:
                noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            action = mean + std * noise
        action = torch.minimum(torch.maximum(action, self.action_low), self.action_high)
        return action, gaussian_log_prob(action, mean, std), value


def gaussian_log_prob(x: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    """Sum over the action axis of the diagonal-Gaussian log-density."""
    z = (x - mean) / std
    return (-0.5 * (z**2 + LOG_2PI) - torch.log(std)).sum(-1)


def gaussian_entropy(std: Tensor) -> Tensor:
    """Sum over the action axis."""
    return (0.5 * (LOG_2PI + 1.0) + torch.log(std)).sum(-1)
