"""A memory policy: a hybrid Mamba-2 / attention torso under the Gaussian
actor-critic heads, carried from one env step to the next.

The torso is a period of IBM's granite-4.0-h-micro (GraniteMoeHybrid,
https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json)
at its published widths: preset `granite-4.0-h-micro` holds layers 0-9 of
its `layer_types`, nine Mamba-2 layers and one grouped-query attention
layer. Each layer is

    h += residual_multiplier * mixer(RMSNorm(h))
    h += residual_multiplier * W_out(SiLU(g) * u),  [g, u] = W_in(RMSNorm(h))

- Mamba-2 mixer: [z, xBC, dt] = in_proj(h); xBC = SiLU(causal depthwise
  conv(xBC) + bias), split into x (heads x head size), B and C (one group);
  dt = softplus(dt + dt_bias), A = -exp(A_log); per head the recurrence of
  ops/ssm.py; out_proj(RMSNorm(y * SiLU(z))), the norm over all of y.
- Attention: grouped-query heads with no positional encoding, scores
  scaled by attention_multiplier, causal.

Departures from the language model, for a policy: the token embedding is a
Linear from the observation, times embedding_multiplier; the tied LM head
and its logits scaling are replaced by ActorCritic's action-mean head (tanh
box, initial_mean_factor), its free log-std and a value head after a final
RMSNorm; attention sees the episode's last `memory_window` steps (a ring of
keys and values) and not a whole context; float32 only.

Memory per env (`Memory`): the SSM state of every Mamba layer, its conv
state (the last d_conv - 1 inputs) and the attention layers' key / value
ring, all zeroed where an episode starts. It is run state: a checkpoint
holds the model and Adam, and a resumed run starts from zero memory.

Two forms:
- `step(obs, memory, first)`: one env step for a batch (rollout, greedy
  evaluation), advancing `memory` in place (not with commit=False);
- `sequence(obs [B, T], memory0, firsts [B, T])`: the update's form over
  each env's horizon, from the memory stored at the rollout's start, with
  the scan in Mamba-2's chunked form, the decay and the conv taps cut at
  the episode starts, and attention masked to the episode and the window.
  The memory from before the sequence is a fixed input (as Transformer-XL's
  memory and R2D2's stored state are): no gradient flows into it. Under
  autograd each layer keeps only its input and recomputes its activations
  in the backward pass (torch.utils.checkpoint), as pixel_policy does: a
  minibatch of 256 env sequences of 32 steps would otherwise hold ~22 GB
  of activations beside the two copies of the memory (live and stored) of
  1024 envs, ~41 GB, and not fit the card's 80 GB.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch import Tensor, nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.models.vae import lecun_normal_
from carla_ppo_tpu_torch.ops import ssm
from carla_ppo_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class HybridSizes:
    """The torso's widths (the names of the published config.json)."""

    hidden_size: int
    intermediate_size: int  # shared_intermediate_size: the SwiGLU MLP's width
    layer_types: Tuple[str, ...]
    mamba_expand: int
    mamba_n_heads: int
    mamba_d_head: int
    mamba_d_state: int
    mamba_n_groups: int
    mamba_d_conv: int
    mamba_chunk_size: int
    num_attention_heads: int
    num_key_value_heads: int
    attention_multiplier: float
    residual_multiplier: float
    embedding_multiplier: float
    rms_norm_eps: float
    memory_window: int = 128  # steps of the episode that attention sees before the current one

    def __post_init__(self):
        if self.mamba_expand * self.hidden_size != self.mamba_n_heads * self.mamba_d_head:
            raise ValueError("mamba_expand * hidden_size must equal mamba_n_heads * mamba_d_head")
        if self.mamba_n_groups != 1:
            raise NotImplementedError("one B / C group only (mamba_n_groups 1)")
        if self.num_attention_heads % self.num_key_value_heads or self.hidden_size % self.num_attention_heads:
            raise ValueError("heads must divide the hidden size and the key / value heads the heads")
        if set(self.layer_types) - {"mamba", "attention"}:
            raise ValueError(f"unknown layer types in {self.layer_types}")

    @property
    def d_inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def n_mamba(self) -> int:
        return self.layer_types.count("mamba")

    @property
    def n_attention(self) -> int:
        return self.layer_types.count("attention")


PRESETS: Dict[str, HybridSizes] = {
    "granite-4.0-h-micro": HybridSizes(
        hidden_size=2048, intermediate_size=8192,
        layer_types=("mamba",) * 5 + ("attention",) + ("mamba",) * 4,
        mamba_expand=2, mamba_n_heads=64, mamba_d_head=64, mamba_d_state=128, mamba_n_groups=1,
        mamba_d_conv=4, mamba_chunk_size=256, num_attention_heads=32, num_key_value_heads=8,
        attention_multiplier=0.015625, residual_multiplier=0.22, embedding_multiplier=12.0,
        rms_norm_eps=1e-5),
}

@dataclasses.dataclass
class Memory:
    """Per-env memory of the torso, batch on dim 1 of the layer stacks."""

    ssm: Tensor  # [n_mamba, B, H, P, N]
    conv: Tensor  # [n_mamba, B, d_conv - 1, conv_dim]: the last inputs of the conv
    keys: Tensor  # [n_attention, B, W, kv heads, head dim]: a ring, slot = step mod W
    values: Tensor  # [n_attention, B, W, kv heads, head dim]
    length: Tensor  # [B] int64: previous steps of the current episode in the ring (<= W)
    first: Tensor  # [B] bool: the next step starts an episode (its memory is then zeroed)
    slot: int  # the ring slot the next step writes

    def clone(self) -> "Memory":
        return Memory(self.ssm.clone(), self.conv.clone(), self.keys.clone(), self.values.clone(),
                      self.length.clone(), self.first.clone(), self.slot)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.ssm, self.conv, self.keys, self.values))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: Tensor, gate: Tensor | None = None) -> Tensor:
        if gate is not None:
            x = x * F.silu(gate)
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


def _linear(n_in: int, n_out: int, generator, device, bias: bool = False, scale: float = 1.0) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, bias=bias, device=device)
    lecun_normal_(layer.weight, n_in, generator, scale)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _uniform(shape, low: float, high: float, generator, device) -> Tensor:
    return torch.empty(shape, device=device).uniform_(low, high, generator=generator)


class MambaMixer(nn.Module):
    def __init__(self, s: HybridSizes, generator, device):
        super().__init__()
        self.s = s
        H = s.mamba_n_heads
        self.in_proj = _linear(s.hidden_size, s.d_inner + s.conv_dim + H, generator, device)
        # torch's depthwise Conv1d init: U(-1/sqrt(fan in), +), fan in = d_conv
        bound = 1.0 / math.sqrt(s.mamba_d_conv)
        self.conv_weight = nn.Parameter(_uniform((s.conv_dim, s.mamba_d_conv), -bound, bound, generator, device))
        self.conv_bias = nn.Parameter(_uniform((s.conv_dim,), -bound, bound, generator, device))
        # Mamba-2's published init: A = -U[1, 16], dt log-uniform in
        # [0.001, 0.1] (floored at 1e-4) under a softplus, D = 1.
        self.A_log = nn.Parameter(torch.log(_uniform((H,), 1.0, 16.0, generator, device)))
        dt = torch.exp(_uniform((H,), math.log(1e-3), math.log(1e-1), generator, device)).clamp(min=1e-4)
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        self.D = nn.Parameter(torch.ones(H, device=device))
        self.norm = RMSNorm(s.d_inner, s.rms_norm_eps).to(device)
        self.out_proj = _linear(s.d_inner, s.hidden_size, generator, device)

    def _split(self, h: Tensor):
        s = self.s
        return torch.split(self.in_proj(h), [s.d_inner, s.conv_dim, s.mamba_n_heads], dim=-1)

    def _ssm_inputs(self, xbc: Tensor, dt: Tensor):
        s = self.s
        x, B, C = torch.split(xbc, [s.d_inner, s.mamba_d_state, s.mamba_d_state], dim=-1)
        return x, B, C, F.softplus(dt + self.dt_bias), -torch.exp(self.A_log)

    def step(self, h: Tensor, state: Tensor, conv_state: Tensor, first: Tensor, commit: bool) -> Tensor:
        s = self.s
        b = h.shape[0]
        z, xbc, dt = self._split(h)
        window = torch.cat([torch.where(first[:, None, None], 0.0, conv_state), xbc[:, None]], dim=1)
        if commit:
            conv_state.copy_(window[:, 1:])
        xbc = F.silu((window * self.conv_weight.t()).sum(1) + self.conv_bias)
        x, B, C, dt, A = self._ssm_inputs(xbc, dt)
        with profiling.span("ssm.step"):
            y = ssm.ssm_step(state, x.view(b, s.mamba_n_heads, s.mamba_d_head), dt, A, B, C, self.D,
                             first, commit)
        return self.out_proj(self.norm(y.reshape(b, s.d_inner), gate=z))

    def sequence(self, h: Tensor, state0: Tensor, conv0: Tensor, ep: Tensor) -> Tensor:
        s = self.s
        b, T, _ = h.shape
        z, xbc, dt = self._split(h)
        K = s.mamba_d_conv
        padded = torch.cat([conv0, xbc], dim=1)  # [b, K - 1 + T, conv_dim]
        ep_padded = F.pad(ep, (K - 1, 0))  # the conv state's inputs belong to episode 0
        acc = None
        for k in range(K):  # tap k reads the input K - 1 - k steps back, within the episode
            term = torch.where((ep_padded[:, k:k + T] == ep)[..., None],
                               padded[:, k:k + T] * self.conv_weight[:, k], 0.0)
            acc = term if acc is None else acc + term
        x, B, C, dt, A = self._ssm_inputs(F.silu(acc + self.conv_bias), dt)
        with profiling.span("ssm.scan"):
            y = ssm.ssd_scan(x.reshape(b, T, s.mamba_n_heads, s.mamba_d_head), dt, A, B, C, self.D, state0, ep)
        return self.out_proj(self.norm(y.reshape(b, T, s.d_inner), gate=z))


class Attention(nn.Module):
    def __init__(self, s: HybridSizes, generator, device):
        super().__init__()
        self.s = s
        d, kv = s.head_dim, s.num_key_value_heads
        self.q_proj = _linear(s.hidden_size, s.num_attention_heads * d, generator, device)
        self.k_proj = _linear(s.hidden_size, kv * d, generator, device)
        self.v_proj = _linear(s.hidden_size, kv * d, generator, device)
        self.o_proj = _linear(s.num_attention_heads * d, s.hidden_size, generator, device)

    def _qkv(self, h: Tensor):
        s = self.s
        lead = h.shape[:-1]
        kv, d = s.num_key_value_heads, s.head_dim
        q = self.q_proj(h).view(*lead, kv, s.num_attention_heads // kv, d)
        return q, self.k_proj(h).view(*lead, kv, d), self.v_proj(h).view(*lead, kv, d)

    def step(self, h: Tensor, keys: Tensor, values: Tensor, length: Tensor, slot: int,
             commit: bool) -> Tensor:
        """One step: the query attends to its own key and the ring's slots
        that hold the episode's previous `length` steps."""
        s = self.s
        W = keys.shape[1]
        q, k, v = self._qkv(h)  # q [b, kv, G, d], k / v [b, kv, d]
        age = torch.remainder(slot - 1 - torch.arange(W, device=h.device), W) + 1
        valid = age[None] <= length[:, None]  # [b, W]
        scale = s.attention_multiplier
        ring = torch.einsum("bkgd,bwkd->bkgw", q, keys) * scale
        own = (q * k[:, :, None]).sum(-1, keepdim=True) * scale
        p = torch.softmax(torch.cat([ring.masked_fill(~valid[:, None, None], float("-inf")), own], -1), -1)
        out = torch.einsum("bkgw,bwkd->bkgd", p[..., :W], values) + p[..., W:] * v[:, :, None]
        if commit:
            keys[:, slot] = k
            values[:, slot] = v
        return self.o_proj(out.reshape(h.shape[0], -1))

    def sequence(self, h: Tensor, ring_k: Tensor, ring_v: Tensor, ring_valid: Tensor, ep: Tensor) -> Tensor:
        """The sequence form; the ring in time order (oldest first) with
        ring_valid [b, W] marking the slots of the episode of step 0's
        memory. Query t sees the key of step u (ring slot i at step i - W)
        where u <= t, t - u <= W and both lie in one episode."""
        s = self.s
        b, T, _ = h.shape
        W = ring_k.shape[1]
        q, k, v = self._qkv(h)  # q [b, T, kv, G, d]
        keys = torch.cat([ring_k, k], dim=1)
        values = torch.cat([ring_v, v], dim=1)
        t = torch.arange(T, device=h.device)
        i = torch.arange(W, device=h.device)
        ring_ok = ring_valid[:, None, :] & (i[None, None, :] >= t[None, :, None]) & (ep == 0)[:, :, None]
        seq_ok = (ep[:, :, None] == ep[:, None, :]) & (t[None, :, None] >= t[None, None, :]) \
            & (t[None, :, None] - t[None, None, :] <= W)
        ok = torch.cat([ring_ok, seq_ok], dim=-1)  # [b, T, W + T]
        scores = torch.einsum("btkgd,bskd->bkgts", q, keys) * s.attention_multiplier
        p = torch.softmax(scores.masked_fill(~ok[:, None, None], float("-inf")), -1)
        out = torch.einsum("bkgts,bskd->btkgd", p, values)
        return self.o_proj(out.reshape(b, T, -1))


class MLP(nn.Module):
    def __init__(self, s: HybridSizes, generator, device):
        super().__init__()
        self.w_in = _linear(s.hidden_size, 2 * s.intermediate_size, generator, device)
        self.w_out = _linear(s.intermediate_size, s.hidden_size, generator, device)

    def forward(self, h: Tensor) -> Tensor:
        g, u = self.w_in(h).chunk(2, dim=-1)
        return self.w_out(F.silu(g) * u)


class HybridLayer(nn.Module):
    def __init__(self, kind: str, s: HybridSizes, generator, device):
        super().__init__()
        self.kind = kind
        self.input_norm = RMSNorm(s.hidden_size, s.rms_norm_eps).to(device)
        self.mixer = (MambaMixer if kind == "mamba" else Attention)(s, generator, device)
        self.post_norm = RMSNorm(s.hidden_size, s.rms_norm_eps).to(device)
        self.mlp = MLP(s, generator, device)


class HybridActorCritic(nn.Module):
    """The memory policy: observation -> torso -> Gaussian actor-critic heads."""

    recurrent = True

    def __init__(
        self,
        obs_dim: int,
        sizes: HybridSizes | str = "granite-4.0-h-micro",
        num_actions: int = 2,
        action_low: Tuple[float, ...] = (-1.0, 0.0),
        action_high: Tuple[float, ...] = (1.0, 1.0),
        initial_std: float = 1.0,
        initial_mean_factor: float = 0.1,
        generator: torch.Generator | None = None,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        s = PRESETS[sizes] if isinstance(sizes, str) else sizes
        self.sizes = s
        self.num_actions = num_actions
        self.register_buffer("action_low", torch.tensor(action_low, dtype=torch.float32, device=device))
        self.register_buffer("action_high", torch.tensor(action_high, dtype=torch.float32, device=device))
        self.embed = _linear(obs_dim, s.hidden_size, generator, device, bias=True)
        self.layers = nn.ModuleList(HybridLayer(kind, s, generator, device) for kind in s.layer_types)
        self.final_norm = RMSNorm(s.hidden_size, s.rms_norm_eps).to(device)
        self.action_mean = _linear(s.hidden_size, num_actions, generator, device, bias=True,
                                   scale=initial_mean_factor)
        self.action_logstd = nn.Parameter(
            torch.full((num_actions,), math.log(initial_std), dtype=torch.float32, device=device))
        self.value = _linear(s.hidden_size, 1, generator, device, bias=True)

    sample_from = ActorCritic.sample_from

    def forward(self, obs: Tensor):
        raise TypeError("HybridActorCritic is a memory policy: call step(obs, memory, first) or "
                        "sequence(obs, memory0, firsts)")

    def initial_memory(self, batch: int, device: str | torch.device | None = None) -> Memory:
        """Zero memory for `batch` envs, each starting an episode."""
        s = self.sizes
        dev = torch.device(device) if device is not None else self.action_low.device
        W, kv, d = s.memory_window, s.num_key_value_heads, s.head_dim
        return Memory(
            ssm=torch.zeros((s.n_mamba, batch, s.mamba_n_heads, s.mamba_d_head, s.mamba_d_state), device=dev),
            conv=torch.zeros((s.n_mamba, batch, s.mamba_d_conv - 1, s.conv_dim), device=dev),
            keys=torch.zeros((s.n_attention, batch, W, kv, d), device=dev),
            values=torch.zeros((s.n_attention, batch, W, kv, d), device=dev),
            length=torch.zeros(batch, dtype=torch.int64, device=dev),
            first=torch.ones(batch, dtype=torch.bool, device=dev),
            slot=0,
        )

    def heads(self, h: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(action mean, action std [A], value) from the torso's output."""
        h = self.final_norm(h)
        low, high = self.action_low, self.action_high
        mean = low + (torch.tanh(self.action_mean(h)) + 1.0) / 2.0 * (high - low)
        return mean, torch.exp(self.action_logstd), self.value(h).squeeze(-1)

    def step(self, obs: Tensor, memory: Memory, first: Tensor, commit: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
        """(action mean [B, A], std [A], value [B]) of one env step, `first`
        [B] marking the envs whose step starts an episode (their memory is
        zeroed first). Advances `memory` in place (its `first` is the
        caller's to set after the env step), unless `commit` is False."""
        s = self.sizes
        with profiling.span("policy.step"):
            length = torch.where(first, 0, memory.length)
            h = self.embed(obs) * s.embedding_multiplier
            mi = ai = 0
            for layer in self.layers:
                x = layer.input_norm(h)
                if layer.kind == "mamba":
                    out = layer.mixer.step(x, memory.ssm[mi], memory.conv[mi], first, commit)
                    mi += 1
                else:
                    with profiling.span("attn.step"):
                        out = layer.mixer.step(x, memory.keys[ai], memory.values[ai], length, memory.slot, commit)
                    ai += 1
                h = h + s.residual_multiplier * out
                h = h + s.residual_multiplier * layer.mlp(layer.post_norm(h))
            if commit:
                memory.length = torch.clamp(length + 1, max=s.memory_window)
                memory.slot = (memory.slot + 1) % s.memory_window
            return self.heads(h)

    def sample(self, obs: Tensor, memory: Memory, generator: torch.Generator | None = None,
               greedy: bool = False, noise: Tensor | None = None) -> Tuple[Tensor, Tensor, Tensor]:
        """(clipped action, its log-prob, value) of one step from
        memory.first, advancing the memory."""
        return self.sample_from(self.step(obs, memory, memory.first), generator, greedy, noise)

    def sequence(self, obs: Tensor, memory0: Memory, firsts: Tensor,
                 envs: Tensor | None = None) -> Tuple[Tensor, Tensor, Tensor]:
        """(action mean [B, T, A], std [A], value [B, T]) of each env's
        sequence of T observations, from `memory0` (the memory before step
        0, not advanced) with `firsts` [B, T] marking episode starts.
        `envs` [B] picks the rows of memory0 that the sequences continue
        (None: all of them). Each layer gathers its own rows inside its
        recomputed region, so a minibatch never holds a copy of its envs'
        whole memory (4.5 GB for 256 envs of the granite preset)."""
        s = self.sizes
        T = obs.shape[1]
        if T > s.mamba_chunk_size:
            raise ValueError(f"a sequence of {T} steps is longer than one chunk ({s.mamba_chunk_size})")
        ep = ssm.episode_ids(firsts)
        W = s.memory_window
        order = torch.remainder(memory0.slot + torch.arange(W, device=obs.device), W)  # oldest first
        length = _rows(memory0.length, envs)
        ring_valid = (W - torch.arange(W, device=obs.device))[None] <= length[:, None]
        h = self.embed(obs) * s.embedding_multiplier
        mi = ai = 0
        for layer in self.layers:
            if layer.kind == "mamba":
                args = (memory0.ssm[mi], memory0.conv[mi], envs, ep)
                mi += 1
            else:
                args = (memory0.keys[ai], memory0.values[ai], envs, ep, order, ring_valid)
                ai += 1
            h = _recomputed(layer, h, *args) if torch.is_grad_enabled() else _layer_sequence(layer, h, *args)
        return self.heads(h)


def _recomputed(layer: "HybridLayer", h: Tensor, *args) -> Tensor:
    """_layer_sequence keeping only its inputs for the backward, which runs
    it again with the spans off (the recomputation is the backward's work,
    not the forward's)."""
    calls = [0]

    def run(h, *args):
        calls[0] += 1
        if calls[0] == 1:
            return _layer_sequence(layer, h, *args)
        with profiling.suspended():
            return _layer_sequence(layer, h, *args)

    return checkpoint(run, h, *args, use_reentrant=False)


def _rows(t: Tensor, envs: Tensor | None) -> Tensor:
    return t if envs is None else t[envs]


def _layer_sequence(layer: HybridLayer, h: Tensor, first: Tensor, second: Tensor, envs: Tensor | None,
                    ep: Tensor, order: Tensor | None = None, ring_valid: Tensor | None = None) -> Tensor:
    """One layer of the sequence form on the memory0 rows `envs` of its
    (SSM, conv) states or (key, value) ring, the ring put in time order."""
    rm = layer.mixer.s.residual_multiplier
    if layer.kind == "mamba":
        out = layer.mixer.sequence(layer.input_norm(h), _rows(first, envs), _rows(second, envs), ep)
    else:
        with profiling.span("attn.sequence"):
            out = layer.mixer.sequence(layer.input_norm(h), _rows(first, envs)[:, order],
                                       _rows(second, envs)[:, order], ring_valid, ep)
    h = h + rm * out
    return h + rm * layer.mlp(layer.post_norm(h))
