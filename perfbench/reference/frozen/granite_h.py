"""Frozen copy of tests/torch_granite_h_reference.py (the plain reference of
the hybrid memory policy), kept here so that a later change to the tests
cannot change the benchmark's reference. Plain PyTorch; imports nothing of
the program.

Plain reference of the hybrid memory policy (models/hybrid_policy.py):
one period of granite-4.0-h-micro as a policy torso, written from the
published description and run step by step.

Imports only torch; float32 with TF32 off. Weights come as a dict named as
the program's state_dict. Per layer, the projections run over all steps
at once and each mixer's recurrence is a loop over t with explicit masks:

- Mamba-2: the depthwise conv keeps its last d_conv - 1 inputs, zeroed at
  an episode start; S = exp(dt A) S + dt x B^T (S zeroed at an episode
  start), y = S C + D x; out_proj(RMSNorm(y * SiLU(z))).
- Attention: grouped-query heads, no positional encoding, scores times
  attention_multiplier; a query sees its own step and the episode's
  previous `memory_window` steps, kept in time order with a validity mask
  that an episode start clears.

Departures from the language model, as the program has them: a Linear
from the observation (times embedding_multiplier) for the token
embedding; the action-mean (tanh box), log-std and value heads after a
final RMSNorm for the tied LM head; the window of `memory_window` steps
for a whole context; the memory from before a sequence is a fixed input
(no gradient flows into it); float32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

LOG_2PI = math.log(2.0 * math.pi)


def set_exact_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: Tensor, weight: Tensor, eps: float) -> Tensor:
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def linear(x: Tensor, P: Dict[str, Tensor], name: str) -> Tensor:
    bias = P.get(name + ".bias")
    return F.linear(x, P[name + ".weight"], bias)


def ring_in_time_order(keys: Tensor, values: Tensor, length: Tensor, slot: int):
    """The program's key / value ring [B, W, kv, d] (slot = step mod W, the
    next to write at `slot`) in time order, oldest first, and which of its
    entries belong to the current episode ([B, W]: the last `length`)."""
    W = keys.shape[1]
    order = [(slot + i) % W for i in range(W)]
    valid = torch.stack([W - i <= length for i in range(W)], dim=1)
    return keys[:, order], values[:, order], valid


def mamba_mixer(P: Dict[str, Tensor], pre: str, s: dict, h: Tensor, state: Tensor, conv_state: Tensor,
                firsts: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(out [B, T, hidden], state after the sequence, conv state after)."""
    H, Pd, N = s["mamba_n_heads"], s["mamba_d_head"], s["mamba_d_state"]
    d_inner = H * Pd
    conv_dim = d_inner + 2 * N
    B_, T, _ = h.shape
    proj = linear(h, P, pre + "in_proj")
    z, xbc, dt = proj[..., :d_inner], proj[..., d_inner:d_inner + conv_dim], proj[..., d_inner + conv_dim:]
    w, bias = P[pre + "conv_weight"], P[pre + "conv_bias"]
    A = -torch.exp(P[pre + "A_log"])
    D = P[pre + "D"]
    dt = F.softplus(dt + P[pre + "dt_bias"])
    ys = []
    for t in range(T):
        reset = firsts[:, t]
        conv_state = torch.where(reset[:, None, None], torch.zeros_like(conv_state), conv_state)
        window = torch.cat([conv_state, xbc[:, t, None]], dim=1)  # [B, K, C], oldest first
        conv_state = window[:, 1:]
        u = F.silu((window * w.t()).sum(1) + bias)
        x = u[:, :d_inner].reshape(B_, H, Pd)
        Bt, Ct = u[:, d_inner:d_inner + N], u[:, d_inner + N:]
        decay = torch.exp(dt[:, t] * A)  # [B, H]
        state = torch.where(reset[:, None, None, None], torch.zeros_like(state), state * decay[:, :, None, None])
        state = state + (dt[:, t, :, None] * x)[..., None] * Bt[:, None, None, :]
        ys.append((state * Ct[:, None, None, :]).sum(-1) + D[None, :, None] * x)
    y = torch.stack(ys, dim=1).reshape(B_, T, d_inner)
    y = rms_norm(y * F.silu(z), P[pre + "norm.weight"], s["rms_norm_eps"])
    return linear(y, P, pre + "out_proj"), state, conv_state


def attention_mixer(P: Dict[str, Tensor], pre: str, s: dict, h: Tensor, ring_k: Tensor, ring_v: Tensor,
                    valid: Tensor, firsts: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(out [B, T, hidden], ring keys, values and validity after)."""
    nh, kv = s["num_attention_heads"], s["num_key_value_heads"]
    d = s["hidden_size"] // nh
    B_, T, _ = h.shape
    q = linear(h, P, pre + "q_proj").reshape(B_, T, nh, d)
    k = linear(h, P, pre + "k_proj").reshape(B_, T, kv, d)
    v = linear(h, P, pre + "v_proj").reshape(B_, T, kv, d)
    outs = []
    for t in range(T):
        valid = valid & ~firsts[:, t, None]
        keys = torch.cat([ring_k, k[:, t, None]], dim=1)  # [B, W + 1, kv, d]
        vals = torch.cat([ring_v, v[:, t, None]], dim=1)
        ok = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)
        keys = keys.repeat_interleave(nh // kv, dim=2)  # query head i reads kv head i // G
        vals = vals.repeat_interleave(nh // kv, dim=2)
        scores = torch.einsum("bhd,bshd->bhs", q[:, t], keys) * s["attention_multiplier"]
        p = torch.softmax(scores.masked_fill(~ok[:, None, :], float("-inf")), dim=-1)
        outs.append(torch.einsum("bhs,bshd->bhd", p, vals).reshape(B_, nh * d))
        ring_k = torch.cat([ring_k[:, 1:], k[:, t, None]], dim=1)
        ring_v = torch.cat([ring_v[:, 1:], v[:, t, None]], dim=1)
        valid = torch.cat([valid[:, 1:], torch.ones_like(valid[:, :1])], dim=1)
    return linear(torch.stack(outs, dim=1), P, pre + "o_proj"), ring_k, ring_v, valid


def forward(P: Dict[str, Tensor], s: dict, obs: Tensor, memory: Dict[str, object], firsts: Tensor,
            return_memory: bool = False):
    """(action mean [B, T, A], std [A], value [B, T]) of the sequences
    obs [B, T, obs_dim] from `memory` (the program's Memory fields as a
    dict: ssm, conv, keys, values, length, slot) with `firsts` [B, T]
    marking episode starts; with `return_memory`, also the memory after
    (ssm, conv, and the rings in time order with their validity)."""
    set_exact_float32()
    rm = s["residual_multiplier"]
    eps = s["rms_norm_eps"]
    memory = {k: (v.detach() if isinstance(v, Tensor) else v) for k, v in memory.items()}
    h = linear(obs, P, "embed") * s["embedding_multiplier"]
    mi = ai = 0
    after = {"ssm": [], "conv": [], "keys": [], "values": [], "valid": []}
    for i, kind in enumerate(s["layer_types"]):
        pre = f"layers.{i}."
        x = rms_norm(h, P[pre + "input_norm.weight"], eps)
        if kind == "mamba":
            out, st, cs = mamba_mixer(P, pre + "mixer.", s, x, memory["ssm"][mi], memory["conv"][mi], firsts)
            after["ssm"].append(st)
            after["conv"].append(cs)
            mi += 1
        else:
            rk, rv, valid = ring_in_time_order(memory["keys"][ai], memory["values"][ai], memory["length"],
                                               memory["slot"])
            out, rk, rv, valid = attention_mixer(P, pre + "mixer.", s, x, rk, rv, valid, firsts)
            for key, val in (("keys", rk), ("values", rv), ("valid", valid)):
                after[key].append(val)
            ai += 1
        h = h + rm * out
        x = rms_norm(h, P[pre + "post_norm.weight"], eps)
        g, u = linear(x, P, pre + "mlp.w_in").chunk(2, dim=-1)
        h = h + rm * linear(F.silu(g) * u, P, pre + "mlp.w_out")
    h = rms_norm(h, P["final_norm.weight"], eps)
    low, high = P["action_low"], P["action_high"]
    mean = low + (torch.tanh(linear(h, P, "action_mean")) + 1.0) / 2.0 * (high - low)
    out = (mean, torch.exp(P["action_logstd"]), linear(h, P, "value").squeeze(-1))
    return (out, after) if return_memory else out


def gaussian_log_prob(x: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    z = (x - mean) / std
    return (-0.5 * (z ** 2 + LOG_2PI) - torch.log(std)).sum(-1)


def ppo_loss(P: Dict[str, Tensor], s: dict, batch: Dict[str, Tensor], memory: Dict[str, object],
             ppo: dict) -> Tensor:
    """The clipped-surrogate loss of env sequences (batch entries [B, T, ...]
    and `firsts`), over the flattened rows, as carla_ppo_tpu_torch's
    ppo_loss writes it."""
    mean, std, value = forward(P, s, batch["obs"], memory, batch["firsts"])
    logp = gaussian_log_prob(batch["actions"], mean, std)
    ratio = torch.exp(logp - batch["log_probs"])
    adv = batch["advantages"]
    eps = ppo["ppo_epsilon"]
    policy = torch.mean(torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv))
    value_loss = torch.mean((value - batch["returns"]) ** 2) * ppo["value_scale"]
    entropy = torch.mean((0.5 * (LOG_2PI + 1.0) + torch.log(std)).sum(-1)) * ppo["entropy_scale"]
    return -policy + value_loss - entropy
