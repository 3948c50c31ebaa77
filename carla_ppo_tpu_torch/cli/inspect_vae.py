"""Interactive VAE latent-space explorer (CLI of the PyTorch / CUDA port).

The port of carla_ppo_tpu/cli/inspect_vae.py: tkinter sliders over the
latent dimensions, the live decoder output, and "set z by image" seeding
from a real frame; `--dump` writes a latent-sweep contact sheet instead
of opening a window (useful on remote machines). Same flags, plus
`--device` (default "cuda"). The window needs tkinter, Pillow and a
display; `--dump` needs neither (the sheet goes through utils/png).

    python -m carla_ppo_tpu_torch.cli.inspect_vae \\
        --model_dir models/torch/vae_models/rgb_bce_cnn_zdim64_beta1_kl_tolerance0.0_data \\
        --dump sweep.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from carla_ppo_tpu_torch.cli import vae_plots
from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.utils.device import exact_float32


def decode_image(model, z: np.ndarray) -> np.ndarray:
    """The decoder's image of one latent `z` [z_dim], uint8 [H, W, 3]; a
    1-channel (seg-target) output is shown through the class palette."""
    with torch.no_grad():
        img = model.generate_from_latent(
            torch.as_tensor(np.asarray(z, np.float32)[None], device=next(model.parameters()).device)
        )[0]
    return (vae_plots.shown(img.cpu().numpy()) * 255).astype(np.uint8)


def dump_sweep(model, out_path: str, dims: int = 10, steps: int = 9,
               z_range: float = 3.0) -> None:
    """A contact sheet of one latent dimension at a time swept over
    [-z_range, z_range]: `dims` rows of `steps` decodes."""
    from carla_ppo_tpu_torch.utils.png import write_png

    h, w = model.out_shape[0], model.out_shape[1]
    dims = min(dims, model.z_dim)
    sheet = np.zeros((dims * h, steps * w, 3), np.uint8)
    for d in range(dims):
        for i, v in enumerate(np.linspace(-z_range, z_range, steps)):
            z = np.zeros(model.z_dim, np.float32)
            z[d] = v
            sheet[d * h:(d + 1) * h, i * w:(i + 1) * w] = decode_image(model, z)
    write_png(out_path, sheet)
    print(f"latent sweep written to {out_path}")


def run_ui(model, source_dir=None) -> None:
    """The tkinter slider window: min(z_dim, 32) latent sliders, Reset,
    and "Set z by image" (the latent mean of a random frame of
    `source_dir`)."""
    import tkinter as tk

    from PIL import Image, ImageTk

    z = np.zeros(model.z_dim, np.float32)

    root = tk.Tk()
    root.title("VAE inspector")
    img_label = tk.Label(root)
    img_label.grid(row=0, column=0, columnspan=4)

    def refresh():
        img = decode_image(model, z)
        img = Image.fromarray(img).resize((img.shape[1] * 3, img.shape[0] * 3),
                                          Image.NEAREST)
        tk_img = ImageTk.PhotoImage(img)
        img_label.configure(image=tk_img)
        img_label.image = tk_img

    sliders = []
    n_show = min(model.z_dim, 32)
    for d in range(n_show):
        def make_cb(dim):
            def cb(val):
                z[dim] = float(val)
                refresh()
            return cb

        s = tk.Scale(root, from_=-3.0, to=3.0, resolution=0.05,
                     orient=tk.HORIZONTAL, length=160, label=f"z{d}",
                     command=make_cb(d))
        s.grid(row=1 + d % ((n_show + 3) // 4), column=d // ((n_show + 3) // 4))
        sliders.append(s)

    def reset():
        z[:] = 0
        for s in sliders:
            s.set(0.0)
        refresh()

    def set_by_image():
        """Seed z from a random frame of the first 50 in `source_dir`."""
        if not source_dir:
            return
        from carla_ppo_tpu_torch.utils.datasets import load_images, preprocess_rgb_frame

        frames = load_images(source_dir, preprocess_rgb_frame, limit=50)
        frame = frames[np.random.randint(len(frames))]
        with torch.no_grad():
            mean = model.encode(torch.as_tensor(frame[None], device=next(model.parameters()).device))
        z[:] = mean.cpu().numpy()[0][: model.z_dim]
        for d, s in enumerate(sliders):
            if d < len(z):
                s.set(float(z[d]))
        refresh()

    tk.Button(root, text="Reset", command=reset).grid(row=0, column=4)
    tk.Button(root, text="Set z by image", command=set_by_image).grid(
        row=1, column=4
    )
    refresh()
    root.mainloop()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Explore a VAE's latent space")
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--source_dir", type=str, default=None,
                        help="Frame folder for 'set z by image'")
    parser.add_argument("--dump", type=str, default=None,
                        help="Write a latent-sweep PNG here instead of a UI")
    parser.add_argument("--dims", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the CPU (no silent fallback)")
    return parser


def main(argv=None) -> None:
    params = build_parser().parse_args(argv)
    exact_float32()
    model = vae_common.load_vae(params.model_dir, device=params.device)
    if params.dump:
        dump_sweep(model, params.dump, dims=params.dims)
    else:
        run_ui(model, params.source_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
