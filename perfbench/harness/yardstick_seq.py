"""The yardstick of the memory-policy cells: the model FLOPs of a PPO
iteration with the hybrid Mamba-2 / attention torso, and the least time of
a call of the state-space step kernel. Computed from the configuration's
published widths and the call's arguments only; nothing here reads the
program. The card's peaks are yardstick.py's.
"""

from __future__ import annotations

from perfbench.harness import yardstick


def widths(config: dict) -> dict:
    """The torso's sizes from a configuration file (its config.json keys)."""
    h = config["hidden_size"]
    H, P, N = config["mamba_n_heads"], config["mamba_d_head"], config["mamba_d_state"]
    d_inner = H * P
    groups = config["mamba_n_groups"]
    return dict(hidden=h, inter=config["shared_intermediate_size"], H=H, P=P, N=N, d_inner=d_inner,
                conv_dim=d_inner + 2 * groups * N, d_conv=config["mamba_d_conv"],
                heads=config["num_attention_heads"], kv=config["num_key_value_heads"],
                head_dim=h // config["num_attention_heads"], window=config["policy"]["memory_window"],
                n_mamba=config["layer_types"].count("mamba"), n_attention=config["layer_types"].count("attention"))


def torso_flops_per_token(config: dict, obs_dim: int, num_actions: int = 2) -> float:
    """Float operations of one forward step of one env: 2 per weight of
    every matrix product (input Linear, in / out projections, q / k / v / o,
    the SwiGLU MLPs, the heads), the depthwise conv (2 per tap), the SSM
    recurrence (the decay, the rank-1 update and its add, y = S C and its
    sum: 5 per state element), and attention's scores and weighted values
    over a full window (the current step and `memory_window` before it:
    2 x 2 x heads x head_dim per key)."""
    w = widths(config)
    h = w["hidden"]
    mlp = 2 * (h * 2 * w["inter"] + w["inter"] * h)
    mamba = 2 * (h * (w["d_inner"] + w["conv_dim"] + w["H"]) + w["d_inner"] * h) \
        + 2 * w["d_conv"] * w["conv_dim"] + 5 * w["H"] * w["P"] * w["N"] + mlp
    attn = 2 * (2 * h * h + 2 * h * w["kv"] * w["head_dim"]) \
        + 4 * w["heads"] * w["head_dim"] * (w["window"] + 1) + mlp
    ends = 2 * (obs_dim * h + h * num_actions + h)
    return w["n_mamba"] * mamba + w["n_attention"] * attn + ends


def iteration_flops(config: dict) -> float:
    """Float operations of one PPO iteration of a memory policy on frozen-VAE
    latents: the rollout's encoder and mean head over horizon + 1 frame
    batches, the torso's forward step over horizon + 1 batches (the last is
    the bootstrap value), then the update's forward and backward (3 x the
    forward) of the torso over every stored step in each epoch. The layers'
    recomputed forward in the backward is not counted."""
    ppo, v, p = config["ppo"], config["vae"], config["policy"]
    obs_dim = v["z_dim"] + len(p["measurements"])
    enc, flat = yardstick._encoder_flops(*v["source_shape"], v["features"])
    vae = enc + 2 * flat * v["z_dim"]
    tok = torso_flops_per_token(config, obs_dim)
    steps = (ppo["horizon"] + 1) * ppo["num_envs"]
    return steps * (vae + tok) + 3 * ppo["num_epochs"] * ppo["horizon"] * ppo["num_envs"] * tok


def ssm_step_bytes(batch: int, H: int, P: int, N: int, resets: int, commit: bool) -> int:
    """Bytes one state-space step call must move: the state of every env
    that does not start an episode read, every env's state written (with
    commit), and x, B, C, dt read and y written once."""
    state = H * P * N * 4
    return (batch - resets) * state + (batch * state if commit else 0) + 4 * batch * (2 * H * P + 2 * N + H)


def ssm_step_bound_ms(kept) -> float:
    """Least ms of one kernel call (kept = (batch, H, P, N, first, commit)):
    bytes over the HBM rate (its arithmetic, 5 operations per state
    element, is far below)."""
    batch, H, P, N, first, commit = kept
    resets = int(first.sum())
    return yardstick.bound(ssm_step_bytes(batch, H, P, N, resets, commit),
                           [(5 * batch * H * P * N, yardstick.FP32_OPS_PER_S)])[0]


def ssm_step_inputs(args) -> tuple:
    """What the bound keeps of a call's arguments (state, x, dt, A, B, C, D,
    first, commit): the sizes, the reset flags and commit."""
    state, first = args[0], args[7]
    commit = args[8] if len(args) > 8 else True
    return (*state.shape, first, bool(commit))
