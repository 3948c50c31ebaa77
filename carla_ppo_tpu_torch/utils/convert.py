"""Carry weights and env states across from the JAX package's layouts.

Inputs are plain nested dicts of numpy arrays (a flax parameter tree after
`jax.tree.map(np.asarray, ...)`, or a pytree's fields), so this module needs
neither JAX nor the JAX package:

- Dense kernel [in, out]            -> torch Linear weight [out, in];
- Conv kernel HWIO                  -> torch Conv2d weight OIHW;
- the ConvVAE latent heads: the JAX encoder flattens NHWC, this port's
  encoder flattens NCHW, so the heads' input rows are permuted.
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


def vae_encoder_state_dict(
    tree: Mapping[str, Any], encoded_shape: Tuple[int, int, int]
) -> Dict[str, torch.Tensor]:
    """flax VAE params -> models.vae.VAE state_dict (encoder + latent heads;
    the decoder is not ported and is ignored)."""
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


_VEHICLE_FIELDS = ("pos", "yaw", "vx", "vy", "yaw_rate", "steer_angle")
_INT_FIELDS = {"waypoint_idx", "start_waypoint_idx", "checkpoint_idx", "step_count",
               "termination_reason"}
_BOOL_FIELDS = {"terminal", "truncated", "is_training", "collision", "lane_invasion"}


def env_state_from_arrays(fields: Mapping[str, Any], device="cpu") -> EnvState:
    """Batched EnvState from a mapping of the JAX EnvState's field names to
    [B, ...] arrays (`vehicle` a mapping of its own). Fields the port does
    not keep (rng, route fields) are ignored."""
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
