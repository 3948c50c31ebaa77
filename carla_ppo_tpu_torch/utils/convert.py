"""Carry weights and env states across from the JAX package's layouts.

Inputs are plain nested dicts of numpy arrays (a flax parameter tree after
`jax.tree.map(np.asarray, ...)`, or a pytree's fields), so this module needs
neither JAX nor the JAX package:

- Dense kernel [in, out]            -> torch Linear weight [out, in];
- Conv kernel HWIO                  -> torch Conv2d weight OIHW;
- the ConvVAE latent heads: the JAX encoder flattens NHWC, this port's
  encoder flattens NCHW, so the heads' input rows are permuted;
- ConvTranspose kernel (kh, kw, in, out) -> torch ConvTranspose2d weight
  (in, out, kh, kw) flipped on both spatial axes: flax applies the kernel
  unflipped (transpose_kernel=False), torch's transposed convolution (the
  gradient of a convolution) flips it;
- a whole PPO train state (`train_state_tree`): the ActorCritic params, the
  optax Adam moments `mu` / `nu` (flax param trees, converted exactly like
  the params, so every moment sits beside its parameter) and `count`, the
  counters and the reward-normalisation moments, in the tree that
  utils.checkpoint saves. The JAX PRNG key cannot be carried over: the tree
  has no generator state, and a restore keeps the template's generator,
  which the Trainer seeds from TrainerSettings.seed;
- the traffic-light table of an EnvParams (`light_table`): the JAX
  arrays as the port's tensors and host floats;
- the pixel agent (`pixel_actor_critic_state_dict`, `pixel_train_state_tree`):
  the conv encoder, z heads and decoder as in the VAE (the heads' rows
  permuted), the ActorCritic under `policy.`, and optax's two-group
  `multi_transform` state as one AdamState per group.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from carla_ppo_tpu_torch.envs.types import EnvState, VehicleState


def _params(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """Accept either flax `variables` ({"params": ...}) or the params tree."""
    return tree["params"] if "params" in tree else tree


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32))


def dense(kernel, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    return _t(np.asarray(kernel).T), _t(bias)


def conv_hwio_to_oihw(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def nhwc_rows_to_nchw(kernel, encoded_shape: Tuple[int, int, int]) -> np.ndarray:
    """Permute a Dense kernel's input rows from NHWC-flatten order to
    NCHW-flatten order: [h*w*c, out] -> [c*h*w, out]."""
    h, w, c = encoded_shape
    k = np.asarray(kernel)
    return k.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c, -1)


def actor_critic_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ActorCritic params -> models.policy.ActorCritic state_dict
    (without the action-box buffers, load with strict=False)."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    for trunk in ("pi", "vf"):
        if trunk not in p:
            continue
        for name, layer in p[trunk].items():
            i = int(name.split("_")[-1])
            w, b = dense(layer["kernel"], layer["bias"])
            out[f"{trunk}.dense.{i}.weight"], out[f"{trunk}.dense.{i}.bias"] = w, b
    for head in ("action_mean", "value"):
        out[f"{head}.weight"], out[f"{head}.bias"] = dense(p[head]["kernel"], p[head]["bias"])
    out["action_logstd"] = _t(p["action_logstd"])
    return out


def train_state_tree(
    params: Mapping[str, Any],
    adam: Mapping[str, Any],
    counters: Mapping[str, Any],
    reward_norm: Mapping[str, Any],
    action_low: Tuple[float, ...] = (-1.0, 0.0),
    action_high: Tuple[float, ...] = (1.0, 1.0),
) -> Dict[str, Any]:
    """A JAX TrainState (as numpy trees) -> the checkpoint tree of
    training.ppo.TrainState, without a generator state.

    `adam` holds optax ScaleByAdamState's `count`, `mu` and `nu`;
    `counters` the JAX state's `iteration`, `train_step`, `total_env_steps`
    and `episodes_done`; `reward_norm` its RunningMoments fields."""
    model = actor_critic_state_dict(params)
    model["action_low"] = torch.tensor(action_low, dtype=torch.float32)
    model["action_high"] = torch.tensor(action_high, dtype=torch.float32)
    moments = {k: actor_critic_state_dict(adam[k]) for k in ("mu", "nu")}
    return {
        "model": model,
        "opt_state": {"count": torch.tensor(int(np.asarray(adam["count"])), dtype=torch.int32),
                      **moments},
        **_counter_tree(counters, reward_norm),
    }


def _counter_tree(counters: Mapping[str, Any], reward_norm: Mapping[str, Any]) -> Dict[str, Any]:
    return {
        "iteration": int(np.asarray(counters["iteration"])),
        "train_step": int(np.asarray(counters["train_step"])),
        "total_env_steps": float(np.asarray(counters["total_env_steps"])),
        "episodes_done": int(np.asarray(counters["episodes_done"])),
        "reward_norm": {k: _t(reward_norm[k]) for k in ("mean", "var", "count")},
    }


def vae_encoder_state_dict(
    tree: Mapping[str, Any], encoded_shape: Tuple[int, int, int]
) -> Dict[str, torch.Tensor]:
    """flax conv VAE params -> the conv encoder's and latent heads' entries
    of a models.vae.VAE state_dict; any decoder in the tree is left to
    vae_state_dict, which calls this for the conv VAE."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    enc = p["encoder"]
    for i in range(len(enc)):
        layer = enc[f"conv{i + 1}"]
        out[f"encoder.convs.{i}.weight"] = conv_hwio_to_oihw(layer["kernel"])
        out[f"encoder.convs.{i}.bias"] = _t(layer["bias"])
    for jax_name, name in (("mean", "mean_head"), ("logstd_square", "logstd_head")):
        k = nhwc_rows_to_nchw(p[jax_name]["kernel"], encoded_shape)
        out[f"{name}.weight"], out[f"{name}.bias"] = dense(k, p[jax_name]["bias"])
    return out


def conv_transpose_to_torch(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, in, out) -> torch ConvTranspose2d
    weight (in, out, kh, kw), spatially flipped."""
    k = np.asarray(kernel)[::-1, ::-1]
    return _t(np.transpose(k, (2, 3, 0, 1)))


def vae_state_dict(
    tree: Mapping[str, Any], source_shape: Tuple[int, int, int], model_type: str = "cnn",
) -> Dict[str, torch.Tensor]:
    """flax VAE params -> models.vae.VAE state_dict: encoder, latent heads
    and (where the tree has one) decoder, for the conv or the MLP VAE."""
    p = _params(tree)
    if model_type == "cnn":
        from carla_ppo_tpu_torch.models.vae import encoded_conv_shape

        out = vae_encoder_state_dict(p, encoded_conv_shape(source_shape))
    else:
        out = {}
        for i in range(len(p["encoder"])):
            layer = p["encoder"][f"dense_{i}"]
            out[f"encoder.dense.{i}.weight"], out[f"encoder.dense.{i}.bias"] = dense(
                layer["kernel"], layer["bias"])
        for jax_name, name in (("mean", "mean_head"), ("logstd_square", "logstd_head")):
            out[f"{name}.weight"], out[f"{name}.bias"] = dense(
                p[jax_name]["kernel"], p[jax_name]["bias"])
    if "decoder" not in p:
        return out
    dec = p["decoder"]
    if model_type == "cnn":
        out["decoder.dense.weight"], out["decoder.dense.bias"] = dense(
            dec["dense1"]["kernel"], dec["dense1"]["bias"])
        for i in range(4):
            layer = dec[f"deconv{i + 1}"]
            out[f"decoder.deconvs.{i}.weight"] = conv_transpose_to_torch(layer["kernel"])
            out[f"decoder.deconvs.{i}.bias"] = _t(layer["bias"])
    else:
        n_hidden = len(dec) - 1
        for i in range(n_hidden):
            layer = dec[f"dense_{i}"]
            out[f"decoder.dense.{i}.weight"], out[f"decoder.dense.{i}.bias"] = dense(
                layer["kernel"], layer["bias"])
        out["decoder.dense_out.weight"], out["decoder.dense_out.bias"] = dense(
            dec["dense_out"]["kernel"], dec["dense_out"]["bias"])
    return out


# The parameter groups of the pixel agent's two-group optimizer
# (training/pixels.py): these top-level flax names are the policy group,
# the rest (encoder, z heads, decoder) the encoder group.
PIXEL_POLICY_TOPLEVEL = ("pi", "action_mean", "vf", "value", "action_logstd")


def pixel_actor_critic_state_dict(
    tree: Mapping[str, Any], frame_shape: Tuple[int, int, int] = (80, 160, 1),
) -> Dict[str, torch.Tensor]:
    """flax PixelActorCritic params -> models.pixel_policy.PixelActorCritic
    state_dict (without the action-box buffers). A tree holding one
    optimizer group only (an Adam moment of the encoder or the policy
    group) converts to that group's entries."""
    p = _params(tree)
    out: Dict[str, torch.Tensor] = {}
    if "encoder" in p:
        vae_view = {"encoder": p["encoder"], "mean": p["z_mean"], "logstd_square": p["z_logstd_sq"]}
        if "decoder" in p:
            vae_view["decoder"] = p["decoder"]
        out.update(vae_state_dict(vae_view, frame_shape))
    if "pi" in p:
        out.update({f"policy.{k}": v for k, v in actor_critic_state_dict(p).items()})
    return out


def pixel_train_state_tree(
    params: Mapping[str, Any],
    adams: Mapping[str, Mapping[str, Any]],
    counters: Mapping[str, Any],
    reward_norm: Mapping[str, Any],
    action_low: Tuple[float, ...] = (-1.0, 0.0),
    action_high: Tuple[float, ...] = (1.0, 1.0),
) -> Dict[str, Any]:
    """A JAX pixel TrainState (as numpy trees) -> the checkpoint tree of
    training.pixels.PixelTrainState, without a generator state.

    `adams` maps each optimizer group ("policy", "encoder") to its optax
    ScaleByAdamState's `count`, `mu` and `nu`, the moments holding that
    group's parameters only (optax's MaskedNode leaves of the other group
    dropped); each group keeps its own count."""
    model = pixel_actor_critic_state_dict(params)
    model["policy.action_low"] = torch.tensor(action_low, dtype=torch.float32)
    model["policy.action_high"] = torch.tensor(action_high, dtype=torch.float32)
    opt = {}
    for group, adam in adams.items():
        opt[group] = {"count": torch.tensor(int(np.asarray(adam["count"])), dtype=torch.int32),
                      **{k: pixel_actor_critic_state_dict(adam[k]) for k in ("mu", "nu")}}
    return {"model": model, "opt_state": opt, **_counter_tree(counters, reward_norm)}


def light_table(fields: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """The traffic-light fields of a JAX EnvParams (a mapping of its field
    names to arrays) as keyword arguments of the port's EnvParams: the
    waypoint and phase tables as int32 / float32 tensors on `device`, the
    cycle's period and fractions as host floats. An empty table converts to
    the port's defaults."""
    dev = torch.device(device)
    return {
        "light_wp": torch.as_tensor(np.array(fields["light_wp"], np.int32), device=dev),
        "light_phase": torch.as_tensor(np.array(fields["light_phase"], np.float32), device=dev),
        **{k: float(np.asarray(fields[k])) for k in ("light_period", "light_green_frac",
                                                      "light_yellow_frac")},
    }


_VEHICLE_FIELDS = ("pos", "yaw", "vx", "vy", "yaw_rate", "steer_angle")
_INT_FIELDS = {"waypoint_idx", "start_waypoint_idx", "checkpoint_idx", "step_count",
               "termination_reason", "route_id", "num_routes_completed"}
_BOOL_FIELDS = {"terminal", "truncated", "is_training", "collision", "lane_invasion"}


def env_state_from_arrays(fields: Mapping[str, Any], device="cpu") -> EnvState:
    """Batched EnvState from a mapping of the JAX EnvState's field names to
    [B, ...] arrays (`vehicle` a mapping of its own), route fields
    included. The JAX state's `rng` is ignored: the port draws from
    explicit torch.Generators."""
    dev = torch.device(device)

    def conv(name, x):
        dtype = torch.int32 if name in _INT_FIELDS else (
            torch.bool if name in _BOOL_FIELDS else torch.float32)
        return torch.as_tensor(np.array(x), device=dev).to(dtype)

    veh = fields["vehicle"]
    vehicle = VehicleState(**{k: conv(k, veh[k]) for k in _VEHICLE_FIELDS})
    names = [f for f in EnvState.__dataclass_fields__ if f != "vehicle"]
    return EnvState(vehicle=vehicle, **{k: conv(k, fields[k]) for k in names})


def env_state_to_arrays(state: EnvState) -> Dict[str, Any]:
    """Inverse of env_state_from_arrays (numpy on the host)."""
    out: Dict[str, Any] = {
        "vehicle": {k: getattr(state.vehicle, k).cpu().numpy() for k in _VEHICLE_FIELDS}
    }
    for k in EnvState.__dataclass_fields__:
        if k != "vehicle":
            out[k] = getattr(state, k).cpu().numpy()
    return out
