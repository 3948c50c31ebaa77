"""Train a beta-VAE on collected frames (CLI of the PyTorch / CUDA port).

The flags and defaults of carla_ppo_tpu/cli/train_vae.py, plus `--device`
(default "cuda"). One deliberate difference: `--models_dir` defaults to
models/torch/vae_models, beside the port's converted VAEs, because
vae/models holds the JAX package's checkpoints. The model directory's name
comes from vae_common.model_dir_name, so vae_common.load_vae (and
cli.train --vae_model) read what this writes. A model directory that
already holds checkpoints (a converted VAE has the same name as the one
this would train) is refused, never added to.

Example, on frames written by cli.collect_data:
  python -m carla_ppo_tpu_torch.cli.train_vae --dataset vae/data --epochs 20
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.training.vae_trainer import VAETrainConfig, make_vae, train_vae
from carla_ppo_tpu_torch.utils import datasets
from carla_ppo_tpu_torch.utils.checkpoint import Checkpointer
from carla_ppo_tpu_torch.utils.device import exact_float32, make_generator, resolve_device
from carla_ppo_tpu_torch.utils.metrics import MetricsWriter


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Trains a VAE on frame folders")
    parser.add_argument("--dataset", type=str, default="vae/data",
                        help="Folder containing rgb/ and segmentation/")
    parser.add_argument("--models_dir", type=str, default="models/torch/vae_models")
    parser.add_argument("--z_dim", type=int, default=64)
    parser.add_argument("--beta", type=float, default=1.0)
    parser.add_argument("--kl_tolerance", type=float, default=0.0)
    parser.add_argument("--loss_type", type=str, default="bce",
                        choices=["bce", "bce_v2", "mse"])
    parser.add_argument("--model_type", type=str, default="cnn",
                        choices=["cnn", "mlp"])
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--batch_size", type=int, default=100)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--early_stop_patience", type=int, default=10)
    parser.add_argument("--use_segmentation_as_target", type=lambda v: bool(int(v)),
                        default=True)
    parser.add_argument("--source", type=str, default="rgb",
                        choices=["rgb", "seg"],
                        help="Encoder input: rgb frames or the 1-channel "
                             "segmentation maps themselves")
    parser.add_argument("--limit", type=int, default=None,
                        help="Cap dataset size (debug)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the host (no silent fallback)")
    return parser


def main(argv=None) -> Dict[str, list]:
    """Trains, checkpoints the best-val model, and returns the history."""
    params = build_parser().parse_args(argv)
    dev = resolve_device(params.device)
    exact_float32()

    print("Loading images...")
    seg_dir = os.path.join(params.dataset, "segmentation")
    if params.source == "seg":
        source = datasets.load_images(seg_dir, datasets.preprocess_seg_frame, limit=params.limit)
    else:
        source = datasets.load_images(os.path.join(params.dataset, "rgb"),
                                      datasets.preprocess_rgb_frame, limit=params.limit)
    if params.use_segmentation_as_target:
        target = datasets.load_images(seg_dir, datasets.preprocess_seg_frame, limit=params.limit)
    else:
        target = source
    print(f"source {source.shape} target {target.shape}")

    train_src, val_src = datasets.train_val_split(source, seed=params.seed)
    train_tgt, val_tgt = datasets.train_val_split(target, seed=params.seed)

    config = VAETrainConfig(
        z_dim=params.z_dim,
        beta=params.beta,
        kl_tolerance=params.kl_tolerance,
        loss_type=params.loss_type,
        learning_rate=params.learning_rate,
        batch_size=params.batch_size,
        epochs=params.epochs,
        early_stop_patience=params.early_stop_patience,
        model_type=params.model_type,
    )
    model = make_vae(config, source_shape=tuple(source.shape[1:]),
                     target_shape=tuple(target.shape[1:]),
                     generator=make_generator(params.seed, "cpu")).to(dev)

    name = vae_common.model_dir_name(
        "seg" if params.use_segmentation_as_target else "rgb",
        params.loss_type, params.model_type, params.z_dim, params.beta,
        params.kl_tolerance, source_depth=source.shape[-1],
    )
    model_dir = os.path.join(params.models_dir, name)
    ckpt_dir = os.path.join(model_dir, "checkpoints")
    if os.path.isdir(ckpt_dir) and any(e.isdigit() for e in os.listdir(ckpt_dir)):
        raise FileExistsError(f"{model_dir} already holds checkpoints; pass another --models_dir")
    ckpt = Checkpointer(ckpt_dir)
    writer = MetricsWriter(os.path.join(model_dir, "logs"))

    def log_fn(epoch, split, metrics):
        writer.write_scalars({f"{split}/{k}": v for k, v in metrics.items()}, epoch)
        if split == "val":
            print(
                f"epoch {epoch}: val loss {metrics['loss']:.2f} "
                f"(recon {metrics['reconstruction_loss']:.2f}, "
                f"kl {metrics['kl_loss']:.2f})", flush=True
            )

    print(f"Training -> {model_dir}")
    _, history = train_vae(model, train_src, train_tgt, val_src, val_tgt, config,
                           seed=params.seed, checkpointer=ckpt, log_fn=log_fn)
    print(f"best val loss: {min(history['val_loss']):.3f} "
          f"after {len(history['val_loss'])} epochs")
    writer.close()
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
