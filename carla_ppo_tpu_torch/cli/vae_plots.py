"""VAE analysis figures (CLI of the PyTorch / CUDA port).

The port of carla_ppo_tpu/cli/vae_plots.py: latent sweep grids (one
dimension at a time) with seg outputs in the CARLA 13-class palette, and
source / reconstruction side-by-sides of up to six frames of
<dataset>/rgb, written as matplotlib figures (latent_sweep.png,
reconstructions.png under --out_dir). Same flags, plus `--device`
(default "cuda"). The arrays come from `latent_sweep` and
`reconstructions`, which need no matplotlib; `main` draws them.

    python -m carla_ppo_tpu_torch.cli.vae_plots \\
        --model_dir models/torch/vae_models/rgb_bce_cnn_zdim64_beta1_kl_tolerance0.0_data \\
        --out_dir plots --dataset vae/data
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Tuple

import numpy as np
import torch

from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.ops.rasterizer import SEG_PALETTE
from carla_ppo_tpu_torch.utils.device import exact_float32


def class_image(img: np.ndarray) -> np.ndarray:
    """Seg-channel [H,W,1] in [0,1] -> palette RGB."""
    cls = np.clip(np.round(img[..., 0] * 12.0), 0, 12).astype(np.int32)
    return SEG_PALETTE.numpy()[cls]


def shown(img: np.ndarray) -> np.ndarray:
    """What a figure shows of a decoder output: the palette for one
    channel, else the output itself."""
    return class_image(img) if img.shape[-1] == 1 else img


def latent_sweep(model, dims: int, steps: int, z_range: float) -> Tuple[np.ndarray, np.ndarray]:
    """(sweep values [steps], decoder outputs [min(dims, z_dim), steps,
    H, W, C] in [0, 1]): latent dimension d set to each value, the others
    0, decoded in one batch."""
    dims = min(dims, model.z_dim)
    sweep = np.linspace(-z_range, z_range, steps)
    z = np.zeros((dims, steps, model.z_dim), np.float32)
    for d in range(dims):
        z[d, :, d] = sweep
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model.generate_from_latent(torch.as_tensor(z.reshape(dims * steps, -1), device=dev))
    return sweep, out.cpu().numpy().reshape(dims, steps, *model.out_shape)


def reconstructions(model, dataset: str) -> Tuple[np.ndarray, np.ndarray]:
    """(the first six frames of <dataset>/rgb in [0, 1], their
    reconstructions [n, H, W, C])."""
    from carla_ppo_tpu_torch.utils.datasets import load_images, preprocess_rgb_frame

    frames = load_images(os.path.join(dataset, "rgb"), preprocess_rgb_frame, limit=6)
    dev = next(model.parameters()).device
    with torch.no_grad():
        recon = model.reconstruct(torch.as_tensor(frames, device=dev))
    return frames, recon.cpu().numpy()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="VAE latent sweep figures")
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, default="vae/plots")
    parser.add_argument("--dims", type=int, default=8)
    parser.add_argument("--steps", type=int, default=9)
    parser.add_argument("--z_range", type=float, default=3.0)
    parser.add_argument("--dataset", type=str, default=None,
                        help="Frame folder for reconstruction side-by-sides")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the CPU (no silent fallback)")
    return parser


def main(argv=None) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    params = build_parser().parse_args(argv)
    exact_float32()
    model = vae_common.load_vae(params.model_dir, device=params.device)
    os.makedirs(params.out_dir, exist_ok=True)

    sweep, images = latent_sweep(model, params.dims, params.steps, params.z_range)
    dims = len(images)
    fig, axes = plt.subplots(
        dims, params.steps, figsize=(params.steps * 1.6, dims * 0.9)
    )
    for d in range(dims):
        for i, v in enumerate(sweep):
            ax = axes[d, i] if dims > 1 else axes[i]
            ax.imshow(shown(images[d, i]))
            ax.set_xticks([]), ax.set_yticks([])
            if i == 0:
                ax.set_ylabel(f"z{d}", fontsize=7)
            if d == 0:
                ax.set_title(f"{v:+.1f}", fontsize=7)
    fig.suptitle("Latent sweeps (one dim at a time)")
    sweep_path = os.path.join(params.out_dir, "latent_sweep.png")
    fig.savefig(sweep_path, dpi=130, bbox_inches="tight")
    print(f"wrote {sweep_path}")

    if params.dataset:
        frames, recon = reconstructions(model, params.dataset)
        fig, axes = plt.subplots(2, len(frames), figsize=(len(frames) * 1.8, 3.2))
        for i in range(len(frames)):
            axes[0, i].imshow(frames[i])
            axes[1, i].imshow(shown(recon[i]))
            for r in range(2):
                axes[r, i].set_xticks([]), axes[r, i].set_yticks([])
        axes[0, 0].set_ylabel("source")
        axes[1, 0].set_ylabel("reconstruction")
        recon_path = os.path.join(params.out_dir, "reconstructions.png")
        fig.savefig(recon_path, dpi=130, bbox_inches="tight")
        print(f"wrote {recon_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
