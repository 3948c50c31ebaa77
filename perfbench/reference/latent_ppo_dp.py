"""Reference of the data-parallel latent PPO cells: the ranks' envs and
updates worked out again as one batch.

Data parallel over `world` ranks of n envs each (ppo.train_iteration with
`dp`) is, in exact arithmetic, one PPO iteration over the world x n envs
together: each rank rolls out its slice; the advantages are normalised by
the moments of every rank's values; each update averages the ranks'
gradients, and every rank's minibatch loss is a mean over the same number
of rows, so the average is the gradient of the mean loss over the union of
the ranks' minibatches, where rank r's k-th minibatch is the k-th part of
the shared permutation of its own envs. So `follow` steps each rank's
slice of the env batch with reference/latent_ppo.py's rollout (the
program's actions), joins the slices, and runs reference/ppo_ref.py's
update with the permutation of the whole batch whose k-th part is the
union of the ranks' k-th parts. Plain PyTorch; imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.harness.compare import SampleMoment

from . import latent_ppo, ppo_ref
from .frozen import lap_env, rasterizer
from .frozen.types import map_tensors
from .ppo_ref import Record

__all__ = ["Record", "follow", "union_perms"]


def union_perms(perms: List[torch.Tensor], world: int, n: int, minibatches: int) -> List[torch.Tensor]:
    """The permutations of the whole batch of world x n envs whose k-th
    part is the union over ranks r of (the k-th part of the shared
    permutation of n) + r x n."""
    out = []
    for p in perms:
        parts = p.reshape(minibatches, -1)
        out.append(torch.cat([torch.cat([parts[k] + r * n for r in range(world)]) for k in range(minibatches)]))
    return out


def follow(config: dict, weights, perms: List[List[torch.Tensor]], device: torch.device, steps: int, world: int,
           actions: List[torch.Tensor], moment: Optional[SampleMoment] = None) -> Record:
    """`steps` iterations over the world x n envs with the program's actions
    ([T, world x n, A] per iteration, the ranks' in rank order)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ppo = config["ppo"]
        n = ppo["num_envs"]
        whole = {**ppo, "num_envs": world * n}
        params, vae, model = latent_ppo.build(config, weights, device)
        cam = rasterizer.CameraConfig(**config["camera"])
        gen = torch.Generator(device=device)
        states = lap_env.init_env_batch(params, world * n, gen)
        slices = [map_tensors(lambda t, r=r: t[r * n:(r + 1) * n], states) for r in range(world)]
        named = list(model.named_parameters())
        names = [k for k, _ in named]
        ps = [p for _, p in named]
        opt = ppo_ref.Adam.init(ps)
        rec = Record([], [], {}, {k: p.detach().clone() for k, p in named}, {})

        def loss_of(batch):
            mean, std, value = model(batch["obs"])
            return ppo_ref.clipped_surrogate(mean, std, value, batch, ppo)

        for k in range(steps):
            parts, boots = [], []
            for r in range(world):
                slices[r], traj, boot, _ = latent_ppo.rollout(
                    model, vae, params, slices[r], gen, ppo["horizon"], cam,
                    actions[k][:, r * n:(r + 1) * n], moment)
                parts.append(traj)
                boots.append(boot)
            traj = {key: torch.cat([t[key] for t in parts], 1) for key in parts[0]}
            rec.actions.append(traj["actions"])
            loss, opt = ppo_ref.update(ps, opt, ppo["max_grad_norm"], loss_of, traj, torch.cat(boots), whole,
                                       union_perms(perms[k], world, n, ppo["num_minibatches"]))
            rec.losses.append(loss)
            if k == 0:
                rec.mu1 = dict(zip(names, (m.clone() for m in opt.mu)))
        rec.params_end = {k: p.detach().clone() for k, p in named}
        return rec
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

