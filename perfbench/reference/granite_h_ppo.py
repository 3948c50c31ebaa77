"""Reference of the memory-policy PPO cell (lap_latent_granite_h.train).

Given what the program's check iteration consumed and produced (its
observations of every step and the one after, the episode starts, the
memory stored at the rollout's start, the actions, log-probs, rewards and
dones), and the benchmark's seeded weights, it works out again, with the
plain step-by-step reference of the torso (frozen/granite_h.py) in float32:

- `rollout_forward`: each env's action means and values over the
  iteration's steps and the bootstrap value after them, from the same
  memory, in env blocks;
- `update`: GAE and normalised advantages from its own values, then the
  epochs of minibatch updates over whole env sequences with the
  benchmark's permutations (the clipped surrogate, optax's
  clip_by_global_norm and Adam, as ppo_ref.py has them), each minibatch's
  gradient accumulated over env blocks so that the step-by-step recurrence
  fits the card. It returns Adam's first moment after the first update and
  the parameters after the last.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import Tensor

from . import ppo_ref
from .frozen import gae
from .frozen import granite_h as torso

# The lap env's action box: steer in [-1, 1], throttle in [0, 1].
ACTION_LOW = (-1.0, 0.0)
ACTION_HIGH = (1.0, 1.0)


def sizes(config: dict) -> dict:
    """What frozen/granite_h.forward reads, from the configuration file."""
    keys = ("layer_types", "mamba_n_heads", "mamba_d_head", "mamba_d_state", "num_attention_heads",
            "num_key_value_heads", "hidden_size", "attention_multiplier", "residual_multiplier",
            "embedding_multiplier", "rms_norm_eps")
    return {k: config[k] for k in keys}


def parameters(weights: Dict[str, Tensor], device: torch.device) -> Dict[str, Tensor]:
    """The reference's leaves (copies on `device`, with gradients) and the
    action box."""
    P = {n: w.detach().to(device).clone().requires_grad_(True) for n, w in weights.items()}
    P["action_low"] = torch.tensor(ACTION_LOW, device=device)
    P["action_high"] = torch.tensor(ACTION_HIGH, device=device)
    return P


def _memory(memory0: Dict[str, object], envs) -> Dict[str, object]:
    return {k: (v[:, envs] if k in ("ssm", "conv", "keys", "values") else v[envs] if k == "length" else v)
            for k, v in memory0.items()}


@torch.no_grad()
def rollout_forward(P: Dict[str, Tensor], s: dict, obs: Tensor, firsts: Tensor, memory0: Dict[str, object],
                    block: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(action means [B, T + 1, A], std, values [B, T + 1]) of every env's
    steps: obs [B, T + 1, D] and firsts [B, T + 1] hold the rollout's steps
    and the step after them (the bootstrap value's)."""
    B = obs.shape[0]
    means, values = [], []
    std = None
    for a in range(0, B, block):
        envs = slice(a, min(a + block, B))
        mean, std, value = torso.forward(P, s, obs[envs], _memory(memory0, envs), firsts[envs])
        means.append(mean)
        values.append(value)
    return torch.cat(means), std, torch.cat(values)


def update(P: Dict[str, Tensor], s: dict, config: dict, data: Dict[str, Tensor], memory0: Dict[str, object],
           values: Tensor, bootstrap: Tensor, perms: Sequence[Tensor], block: int) -> Tuple[Dict[str, Tensor], Dict[str, Tensor], List[float]]:
    """(Adam's first moment after the first update, the parameters after
    the last, each update's loss). `data` holds [B, T, ...] obs, firsts,
    actions, log_probs and [T, B] rewards and dones; `values` [T, B] and
    `bootstrap` [B] are the reference's own."""
    ppo = config["ppo"]
    adv = gae.compute_gae(data["rewards"], values, bootstrap, data["dones"], ppo["discount_factor"],
                          ppo["gae_lambda"])
    returns = adv + values
    if ppo["normalize_advantage"]:
        adv = gae.normalize_advantages(adv)
    seq = {"obs": data["obs"], "firsts": data["firsts"], "actions": data["actions"],
           "log_probs": data["log_probs"], "advantages": adv.transpose(0, 1), "returns": returns.transpose(0, 1)}
    names = [n for n in P if n not in ("action_low", "action_high")]
    leaves = [P[n] for n in names]
    opt = ppo_ref.Adam.init(leaves)
    mu_first: Dict[str, Tensor] = {}
    losses = []
    for epoch in range(ppo["num_epochs"]):
        for idx in perms[epoch].reshape(ppo["num_minibatches"], -1):
            for p in leaves:
                p.grad = None
            total = 0.0
            for a in range(0, idx.numel(), block):
                envs = idx[a:a + block]
                batch = {k: v[envs] for k, v in seq.items()}
                weight = envs.numel() / idx.numel()
                loss = torso.ppo_loss(P, s, batch, _memory(memory0, envs), ppo) * weight
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
            new, opt = ppo_ref.clip_and_adam(leaves, grads, opt, ppo, ppo["max_grad_norm"])
            with torch.no_grad():
                for p, q in zip(leaves, new):
                    p.copy_(q)
            if not mu_first:
                mu_first = {n: m.detach().clone() for n, m in zip(names, opt.mu)}
    for p in leaves:
        p.grad = None
    return mu_first, {n: P[n].detach().clone() for n in names}, losses
