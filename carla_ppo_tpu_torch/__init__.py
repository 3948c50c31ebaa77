"""carla_ppo_tpu_torch - the PyTorch / CUDA (NVIDIA Hopper) port of carla_ppo_tpu.

Same system, second engine: the lap-driving simulator, the on-device
semantic camera, the frozen ConvVAE latent observation and clipped PPO,
written as batched PyTorch tensor code, with the camera's two hot loops
(the ground pass and the billboard composite) as hand-written CUDA kernels
for sm_90a (`ops/rasterizer_cuda.py`, sources in `csrc/`).

The JAX package `carla_ppo_tpu` is the reference this port is held against
by the `tests/test_torch_*.py` parity tests. This package never imports it,
nor JAX.

Layout mirrors the JAX package:
  envs/      track baking, vehicle dynamics, rewards, the lap, route and
             lap-bank envs, scripted agents, the interactive envs (gym_api,
             hud) and their Gymnasium views (gymnasium_api, vector_env)
  models/    ConvVAE, Gaussian actor-critic, the pixel policy
  ops/       camera (plain PyTorch + CUDA kernels), GAE, running stats
  training/  PPO rollout / update / greedy evaluate, the Trainer, the VAE
             trainer, pixel PPO, eval videos (eval_host)
  parallel/  data-parallel PPO over torch.distributed (one rank per card)
  cli/       train, run_eval, collect_data, train_vae; the inspectors
             inspect_vae, inspect_agent (tkinter windows, or --dump) and
             vae_plots (matplotlib figures)
  utils/     device selection, kernel build, weight conversion,
             checkpoints, metrics, datasets, PNG, video, profiling

    python -m carla_ppo_tpu_torch.cli.inspect_agent --model_name torch/latent_agent --dump \\
        --vae_model models/torch/vae_models/from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data

Entry points default to ``device="cuda"`` and raise if no card is present;
pass ``device="cpu"`` explicitly to run the plain PyTorch versions.
"""

__version__ = "0.1.0"
