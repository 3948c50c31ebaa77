"""The Mamba-2 state-space scan of the hybrid policy, in its two forms.

Per env, head h (A_h < 0, D_h) and step t, with the state S of [P, N]:

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t B_t^T     (x_t [P], B_t [N])
    y_t = S_t C_t + D_h * x_t

and S_{t-1} taken as 0 where step t starts an episode.

- `ssm_step` is one step for a batch (the rollout, the greedy evaluation):
  the CUDA kernel (ops/ssm_cuda.py) on CUDA tensors, `ssm_step_plain` on
  CPU tensors. Both advance the state in place unless `commit` is False.
- `ssd_scan` is the sequence form (the update): Mamba-2's chunked
  ("state-space duality") form in plain matrix products, for one chunk of
  T steps, the decay cut at episode boundaries and the state from before
  the sequence (`state0`) a fixed input.
"""

from __future__ import annotations

import torch
from torch import Tensor


def ssm_step_plain(state: Tensor, x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                   D: Tensor, first: Tensor, commit: bool = True) -> Tensor:
    """y [b, H, P] of one step; state [b, H, P, N], x [b, H, P], dt [b, H],
    A and D [H], B and C [b, N], first [b] bool. Each element rounds as the
    kernel's does: the decayed state (0 at an episode's start), plus
    (dt * x) * B, then the sum over N of S * C, plus D * x."""
    decay = torch.exp(dt * A)
    kept = torch.where(first[:, None, None, None], torch.zeros((), dtype=state.dtype, device=state.device),
                       state * decay[:, :, None, None])
    new = kept + (dt[:, :, None] * x)[..., None] * B[:, None, None, :]
    y = (new * C[:, None, None, :]).sum(-1) + D[None, :, None] * x
    if commit:
        state.copy_(new)
    return y


def ssm_step(state: Tensor, x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor,
             first: Tensor, commit: bool = True) -> Tensor:
    """One step: the kernel for CUDA tensors, the plain version for CPU ones."""
    if state.is_cuda:
        from carla_ppo_tpu_torch.ops import ssm_cuda

        return ssm_cuda.ssm_step_cuda(state, x, dt, A, B, C, D, first, commit)
    return ssm_step_plain(state, x, dt, A, B, C, D, first, commit)


def episode_ids(firsts: Tensor) -> Tensor:
    """[b, T] int64: the number of episode starts up to and including each
    step. Two steps share an episode where their ids are equal; a step whose
    id is 0 continues the episode of the memory from before the sequence."""
    return torch.cumsum(firsts.to(torch.int64), dim=1)


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor,
             state0: Tensor, ep: Tensor) -> Tensor:
    """y [b, T, H, P] of a sequence; x [b, T, H, P], dt [b, T, H], A and D
    [H], B and C [b, T, N], state0 [b, H, P, N] (the state before step 0),
    ep [b, T] (episode_ids).

    One chunk of Mamba-2's chunked form: with the cumulative log decay
    c_t = sum_{u <= t} dt_u A,
        y_t = sum_{s <= t, same episode} exp(c_t - c_s) (C_t . B_s) dt_s x_s
              + [ep_t = 0] exp(c_t) S0 C_t + D x_t,
    the first term as a masked [T, T] matrix per head (the decay of a pair
    of steps in different episodes is cut to 0), the second as one product
    of the state with every C_t. No gradient flows into state0."""
    b, T, H, P = x.shape
    cum = torch.cumsum(dt * A, dim=1).transpose(1, 2)  # [b, H, T]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    same = (ep[:, :, None] == ep[:, None, :]) & causal  # [b, T(t), T(s)]
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~same[:, None], float("-inf")))
    scores = decay * torch.bmm(C, B.transpose(1, 2))[:, None]  # [b, H, T, T]
    xdt = (x * dt[..., None]).permute(0, 2, 1, 3)  # [b, H, T, P]
    y = torch.matmul(scores, xdt)
    carried = torch.bmm(state0.detach().reshape(b, H * P, -1), C.transpose(1, 2))  # [b, H*P, T]
    carried = carried.reshape(b, H, P, T).transpose(2, 3)
    y = y + (torch.exp(cum) * (ep == 0)[:, None, :])[..., None] * carried
    y = y + D[None, :, None, None] * x.permute(0, 2, 1, 3)
    return y.permute(0, 2, 1, 3)
