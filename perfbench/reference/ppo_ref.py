"""The PPO update of the reference: GAE, advantage normalisation, env-axis
minibatches, the clipped surrogate with value and entropy terms, and
optax's chain(clip_by_global_norm, adam) with the KL guard, written from
carla_ppo_tpu_torch/training/ppo.py (commit cbdb1fb) for one device and
kept frozen. Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import Tensor

from .frozen import gae
from .frozen.policy import gaussian_entropy, gaussian_log_prob


@dataclasses.dataclass
class Record:
    """What a run of a training cell's first iterations leaves to compare:
    each iteration's actions [T, B, A] and mean loss, Adam's first moment of
    every leaf after iteration 1, the parameters before iteration 1 and
    after the last, and (where recorded) Adam's first moment of every leaf
    after the first update."""

    actions: List[Tensor]
    losses: List[float]
    mu1: Dict[str, Tensor]
    params0: Dict[str, Tensor]
    params_end: Dict[str, Tensor]
    mu_first: Dict[str, Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Adam:
    count: Tensor
    mu: List[Tensor]
    nu: List[Tensor]

    @classmethod
    def init(cls, params: Sequence[Tensor]) -> "Adam":
        return cls(torch.zeros((), dtype=torch.int32, device=params[0].device),
                   [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


def lr_at(ppo: dict, count: Tensor) -> Tensor:
    upi = ppo["num_epochs"] * ppo["num_minibatches"]
    steps = torch.floor(count.to(torch.float32) / upi)
    return ppo["learning_rate"] * torch.pow(
        torch.tensor(ppo["lr_decay"], dtype=torch.float32, device=count.device), steps)


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    return torch.sqrt(sum((t * t).sum() for t in tensors))


@torch.no_grad()
def clip_and_adam(params: Sequence[Tensor], grads: Sequence[Tensor], state: Adam, ppo: dict,
                  clip_norm: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Tuple[List[Tensor], Adam]:
    max_norm = clip_norm if clip_norm > 0 else 1e9
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    grads = [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]
    lr = lr_at(ppo, state.count)
    count = state.count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=cf.device), cf)
    mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1.0 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    new = [p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + eps)) for p, m, v in zip(params, mu, nu)]
    return new, Adam(count, mu, nu)


def clipped_surrogate(mean: Tensor, std: Tensor, value: Tensor, batch: Dict[str, Tensor],
                      ppo: dict) -> Tuple[Tensor, Tensor]:
    """(loss, approx KL) of one minibatch."""
    logp = gaussian_log_prob(batch["actions"], mean, std)
    log_ratio = logp - batch["log_probs"]
    ratio = torch.exp(log_ratio)
    adv = batch["advantages"]
    eps = ppo["ppo_epsilon"]
    policy_loss = torch.mean(torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv))
    value_loss = torch.mean((value - batch["returns"]) ** 2) * ppo["value_scale"]
    entropy_loss = torch.mean(gaussian_entropy(std)) * ppo["entropy_scale"]
    return -policy_loss + value_loss - entropy_loss, torch.mean(ratio - 1.0 - log_ratio).detach()


def minibatches(traj: Dict[str, Tensor], bootstrap: Tensor, ppo: dict,
                perms: Sequence[Tensor]):
    """Yield each update's minibatch (a dict of flat rows): GAE, returns,
    normalised advantages, then contiguous horizons of each epoch's
    permuted envs."""
    adv = gae.compute_gae(traj["rewards"], traj["values"], bootstrap, traj["dones"],
                          ppo["discount_factor"], ppo["gae_lambda"])
    returns = adv + traj["values"]
    if ppo["normalize_advantage"]:
        adv = gae.normalize_advantages(adv)
    T, B = traj["rewards"].shape
    if ppo["minibatch_axis"] != "env" or B % ppo["num_minibatches"]:
        raise ValueError("the reference takes env-axis minibatches only")
    data = {k: traj[k].transpose(0, 1) for k in traj if k not in ("rewards", "values", "dones")}
    data["returns"] = returns.transpose(0, 1)
    data["advantages"] = adv.transpose(0, 1)
    for epoch in range(ppo["num_epochs"]):
        for idx in perms[epoch].reshape(ppo["num_minibatches"], -1):
            yield {k: v[idx].reshape((-1,) + tuple(v.shape[2:])) for k, v in data.items()}


def half(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The fault "half of the batch left out, the mean taken over the rest"."""
    n = next(iter(batch.values())).shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def update(params: List[Tensor], opt: Adam, clip_norm: float,
           loss_of: Callable[[Dict[str, Tensor]], Tuple[Tensor, Tensor]], traj: Dict[str, Tensor],
           bootstrap: Tensor, ppo: dict, perms: Sequence[Tensor],
           fault: str | None = None) -> Tuple[float, Adam]:
    """The epochs of minibatch updates, in place; returns (mean loss over
    the updates, the new Adam state). The KL guard stops every later update
    of the iteration once a minibatch's approx KL is above
    ppo["kl_target"] (> 0); the stopped ones keep the parameters and the
    optimizer state."""
    stop = torch.zeros((), dtype=torch.bool, device=params[0].device)
    losses = []
    for batch in minibatches(traj, bootstrap, ppo, perms):
        if fault == "half":
            batch = half(batch)
        for p in params:
            p.grad = None
        loss, kl = loss_of(batch)
        loss.backward()
        losses.append(loss.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        new_p, new_opt = clip_and_adam(params, grads, opt, ppo, clip_norm)
        if ppo["kl_target"] > 0:
            stop = stop | (kl > ppo["kl_target"])
            keep = ~stop
            new_p = [torch.where(keep, a, b) for a, b in zip(new_p, params)]
            new_opt = Adam(torch.where(keep, new_opt.count, opt.count),
                           [torch.where(keep, a, b) for a, b in zip(new_opt.mu, opt.mu)],
                           [torch.where(keep, a, b) for a, b in zip(new_opt.nu, opt.nu)])
        with torch.no_grad():
            for p, q in zip(params, new_p):
                p.copy_(q)
        opt = new_opt
    for p in params:
        p.grad = None
    return float(torch.stack(losses).mean()), opt
