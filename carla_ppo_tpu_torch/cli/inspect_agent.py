"""Inspect a trained agent's policy over the VAE latent space (CLI of the
PyTorch / CUDA port).

The port of carla_ppo_tpu/cli/inspect_agent.py: sliders perturb the latent
vector z and the driving measurements (steer, throttle, speed); the window
shows the VAE decode of z beside the greedy action the policy takes for
z ++ measurements. `--dump` sweeps one latent dimension and prints the
action response instead (and returns it). Same flags, plus `--device`
(default "cuda"). The agent is models/<model_name>; the window needs
tkinter, Pillow and a display.

    python -m carla_ppo_tpu_torch.cli.inspect_agent --model_name torch/latent_agent \\
        --vae_model models/torch/vae_models/from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data \\
        --dump
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from carla_ppo_tpu_torch.cli.inspect_vae import decode_image
from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.training import ppo
from carla_ppo_tpu_torch.utils.checkpoint import Checkpointer
from carla_ppo_tpu_torch.utils.device import exact_float32, make_generator, resolve_device

# The measurements of --dump and the window's start: steer, throttle, speed.
MEASUREMENTS = (0.0, 0.5, 5.0)


def load_agent(model_name: str, obs_dim: int, models_root: str = "models",
               device: str | torch.device = "cuda") -> ActorCritic:
    """The ActorCritic of the newest checkpoint of
    <models_root>/<model_name>/checkpoints on `device`; raises
    FileNotFoundError when nothing restores."""
    dev = resolve_device(device)
    ckpt_dir = os.path.join(models_root, model_name, "checkpoints")
    if not os.path.isdir(ckpt_dir):  # the Checkpointer would create it
        raise FileNotFoundError(f"no checkpoint for model {model_name}")
    # The template's weights are drawn on the CPU (module init draws there)
    # and replaced by the checkpoint's.
    model = ActorCritic(obs_dim, generator=make_generator(0, "cpu")).to(dev)
    ts = ppo.create_train_state(model, ppo.PPOConfig(), make_generator(0, dev))
    restored = Checkpointer(ckpt_dir).restore_latest(ts)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint for model {model_name}")
    return restored.model.eval()


def make_act(model: ActorCritic):
    """(z [z_dim], measurements [3]) -> (greedy action [2], value), the
    policy's mean and value for the observation z ++ measurements."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def act(z, measurements):
        obs = torch.cat([torch.as_tensor(z, dtype=torch.float32, device=dev),
                         torch.as_tensor(measurements, dtype=torch.float32, device=dev)])[None]
        mean, _, value = model(obs)
        return mean[0].cpu().numpy(), float(value[0])

    return act


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Inspect how a trained policy responds to latent perturbations"
    )
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--vae_model", type=str, required=True)
    parser.add_argument("--dump", action="store_true",
                        help="Print an action-response sweep instead of a UI")
    parser.add_argument("--dump_dim", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the CPU (no silent fallback)")
    return parser


def main(argv=None):
    """With --dump, the sweep's rows (z value, steer, throttle, value);
    else None after the window closes."""
    params = build_parser().parse_args(argv)
    exact_float32()
    vae = vae_common.load_vae(params.vae_model, device=params.device)
    obs_dim = vae.z_dim + 3
    act = make_act(load_agent(params.model_name, obs_dim, device=params.device))

    if params.dump:
        print(f"sweep of z[{params.dump_dim}] -> greedy [steer, throttle], value")
        rows = []
        for v in np.linspace(-3, 3, 13):
            z = np.zeros(vae.z_dim, np.float32)
            z[params.dump_dim] = v
            a, val = act(z, MEASUREMENTS)
            rows.append((float(v), float(a[0]), float(a[1]), val))
            print(
                f"  z={v:+.1f}: steer={float(a[0]):+.3f} "
                f"throttle={float(a[1]):.3f} value={val:.2f}"
            )
        return rows

    import tkinter as tk

    from PIL import Image, ImageTk

    z = np.zeros(vae.z_dim, np.float32)
    meas = np.array(MEASUREMENTS, np.float32)

    root = tk.Tk()
    root.title("Agent inspector")
    img_label = tk.Label(root)
    img_label.grid(row=0, column=0, columnspan=4)
    action_label = tk.Label(root, text="", font=("Courier", 12))
    action_label.grid(row=0, column=4)

    def refresh(*_):
        img = decode_image(vae, z)
        pil = Image.fromarray(img).resize(
            (img.shape[1] * 3, img.shape[0] * 3), Image.NEAREST
        )
        tk_img = ImageTk.PhotoImage(pil)
        img_label.configure(image=tk_img)
        img_label.image = tk_img
        a, val = act(z, meas)
        action_label.configure(
            text=(
                f"steer    {float(a[0]):+.3f}\n"
                f"throttle {float(a[1]):.3f}\n"
                f"value    {val:.2f}"
            )
        )

    n_show = min(vae.z_dim, 24)
    rows = (n_show + 3) // 4
    for d in range(n_show):
        def make_cb(dim):
            def cb(val):
                z[dim] = float(val)
                refresh()
            return cb

        s = tk.Scale(root, from_=-3.0, to=3.0, resolution=0.05,
                     orient=tk.HORIZONTAL, length=150, label=f"z{d}",
                     command=make_cb(d))
        s.grid(row=1 + d % rows, column=d // rows)

    meas_specs = [("steer", -1.0, 1.0), ("throttle", 0.0, 1.0), ("speed", 0.0, 30.0)]
    for i, (name, lo, hi) in enumerate(meas_specs):
        def make_mcb(idx):
            def cb(val):
                meas[idx] = float(val)
                refresh()
            return cb

        s = tk.Scale(root, from_=lo, to=hi, resolution=0.05,
                     orient=tk.HORIZONTAL, length=150, label=name,
                     command=make_mcb(i))
        s.set(float(meas[i]))
        s.grid(row=1 + i, column=4)

    refresh()
    root.mainloop()


if __name__ == "__main__":
    main(sys.argv[1:])
