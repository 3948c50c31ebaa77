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
  envs/      track baking, vehicle dynamics, rewards, the lap env
  models/    ConvVAE encoder, Gaussian actor-critic
  ops/       camera (plain PyTorch + CUDA kernels), GAE, running stats
  training/  PPO rollout / update / greedy evaluate
  utils/     device selection, kernel build, weight conversion

Entry points default to ``device="cuda"`` and raise if no card is present;
pass ``device="cpu"`` explicitly to run the plain PyTorch versions.
"""

__version__ = "0.1.0"
