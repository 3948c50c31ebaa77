"""Command-line entry points of the port (python -m carla_ppo_tpu_torch.cli.<name>)."""
