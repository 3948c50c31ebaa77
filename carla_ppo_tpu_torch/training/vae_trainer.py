"""VAE training loop (port of carla_ppo_tpu/training/vae_trainer.py).

Adam at 1e-4 (torch.optim.Adam with optax's defaults: betas 0.9 / 0.999,
eps 1e-8), batch 100, epochs shuffled with the remainder dropped, the
validation split evaluated each epoch with z = mean, the best-val model
checkpointed, and a stop after `early_stop_patience` (10) epochs without
improvement. The permutations come from numpy's default_rng(seed) in the
JAX trainer's order (train, then val, each epoch), so both packages visit
the same batches; only the sampling noise differs: a torch generator here,
or an injected [num_batches, batch, z_dim] draw.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from carla_ppo_tpu_torch.models.vae import VAE, vae_loss
from carla_ppo_tpu_torch.utils.device import make_generator


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    z_dim: int = 64
    beta: float = 1.0
    kl_tolerance: float = 0.0
    loss_type: str = "bce"
    learning_rate: float = 1e-4
    # lr_decay and val_portion are the JAX config's fields; neither package
    # reads them (the lr stays constant, the CLI splits 10%).
    lr_decay: float = 1.0
    batch_size: int = 100
    epochs: int = 100
    early_stop_patience: int = 10
    val_portion: float = 0.1
    model_type: str = "cnn"


def make_vae(
    config: VAETrainConfig,
    source_shape: Tuple[int, int, int],
    target_shape: Optional[Tuple[int, int, int]] = None,
    generator: torch.Generator | None = None,
) -> VAE:
    """The whole VAE (target_shape defaults to the source's), initialised
    from `generator` as flax initialises it (LeCun normal, zero biases)."""
    return VAE(source_shape=source_shape, target_shape=tuple(target_shape or source_shape),
               z_dim=config.z_dim, model_type=config.model_type, generator=generator)


def make_optimizer(model: VAE, config: VAETrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=config.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def _loss(model: VAE, src: Tensor, tgt: Tensor, noise, config: VAETrainConfig, train: bool):
    logits, mean, logstd_sq = model(src, noise, training=train)
    return vae_loss(logits, tgt, mean, logstd_sq, config.beta, config.kl_tolerance,
                    config.z_dim, config.loss_type)


def run_epoch(
    model: VAE,
    optimizer: torch.optim.Optimizer,
    source: Tensor,
    target: Tensor,
    perm: np.ndarray,
    config: VAETrainConfig,
    noise: Tensor | torch.Generator | None = None,
    train: bool = True,
) -> Dict[str, float]:
    """One epoch over the batches of `perm` ([num_batches, batch_size]
    indices): Adam steps on the sampled-z loss when `train`, else the loss
    at z = mean. `noise` (train only) is a generator or the
    [num_batches, batch_size, z_dim] standard-normal draw. Returns each
    metric's mean over the batches."""
    model.train(train)
    idx_all = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=source.device)
    sums: Dict[str, Tensor] = {}
    for i in range(idx_all.shape[0]):
        idx = idx_all[i]
        src, tgt = source[idx], target[idx]
        if train:
            eps = noise if isinstance(noise, torch.Generator) else noise[i]
            _, metrics = _loss(model, src, tgt, eps, config, True)
            optimizer.zero_grad(set_to_none=True)
            metrics["loss"].backward()
            optimizer.step()
        else:
            with torch.no_grad():
                _, metrics = _loss(model, src, tgt, None, config, False)
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    return {k: float(v) / idx_all.shape[0] for k, v in sums.items()}


def _make_perm(n: int, batch_size: int, rng: np.random.Generator) -> np.ndarray:
    idx = rng.permutation(n)
    nb = n // batch_size
    return idx[: nb * batch_size].reshape(nb, batch_size)


def train_vae(
    model: VAE,
    train_source: np.ndarray,
    train_target: np.ndarray,
    val_source: np.ndarray,
    val_target: np.ndarray,
    config: VAETrainConfig,
    seed: int = 0,
    checkpointer=None,
    log_fn: Optional[Callable[[int, str, Dict[str, float]], None]] = None,
) -> Tuple[Dict[str, Any], Dict[str, list]]:
    """Train `model` (on its device) with early stopping; returns (the best
    epoch's state_dict, history). `checkpointer` (utils.checkpoint) saves
    {"model": state_dict} at each best-val epoch; `log_fn(epoch, split,
    metrics)` receives each epoch's train and val means. The sampling
    noise comes from a generator seeded from `seed` on the model's
    device."""
    dev = next(model.parameters()).device
    generator = make_generator(seed, dev)
    nprng = np.random.default_rng(seed)
    optimizer = make_optimizer(model, config)
    tensors = [torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in (train_source, train_target, val_source, val_target)]
    train_src, train_tgt, val_src, val_tgt = tensors

    best_val = float("inf")
    best_state = copy.deepcopy(model.state_dict())
    epochs_since_best = 0
    history: Dict[str, list] = {"train_loss": [], "val_loss": []}
    for epoch in range(config.epochs):
        perm = _make_perm(len(train_source), config.batch_size, nprng)
        train_metrics = run_epoch(model, optimizer, train_src, train_tgt, perm, config,
                                  generator, train=True)
        val_bs = min(config.batch_size, len(val_source))
        val_perm = _make_perm(len(val_source), val_bs, nprng)
        val_metrics = run_epoch(model, optimizer, val_src, val_tgt, val_perm, config, train=False)
        history["train_loss"].append(train_metrics["loss"])
        history["val_loss"].append(val_metrics["loss"])
        if log_fn is not None:
            log_fn(epoch, "train", train_metrics)
            log_fn(epoch, "val", val_metrics)
        if val_metrics["loss"] < best_val:
            best_val = val_metrics["loss"]
            best_state = copy.deepcopy(model.state_dict())
            epochs_since_best = 0
            if checkpointer is not None:
                checkpointer.save(epoch, {"model": best_state})
        else:
            epochs_since_best += 1
            if epochs_since_best >= config.early_stop_patience:
                break
    return best_state, history
