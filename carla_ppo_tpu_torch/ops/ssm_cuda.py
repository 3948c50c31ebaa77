"""CUDA wrapper of the Mamba-2 state-space step (source in ../csrc/ssm_step.cu).

- `ssm_step_cuda` <- no TPU kernel: the hybrid policy's recurrent step
  (models/hybrid_policy.py), added with it.

The wrapper checks device, dtype, shape, strides and alignment and raises
on anything else, allocates y with torch.empty, launches on the current
stream, raises on a non-zero launch status, and adds one to
LAUNCHES["ssm_step"] per launch. The plain PyTorch version is
ops/ssm.py:ssm_step_plain; the dispatch there (`ssm_step`) takes it only
for CPU tensors.
"""

from __future__ import annotations

import torch
from torch import Tensor

from carla_ppo_tpu_torch.utils.cuda_build import load_library

# The state sizes N the kernel is instantiated for (N / 4 lanes a row): the
# published layer's and the tests' small layers'.
STATE_SIZES = (4, 8, 128)

# Launch counts (always on).
LAUNCHES = {"ssm_step": 0}


def _cuda_f32(name: str, t: Tensor) -> None:
    if not isinstance(t, Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")


def _rows(name: str, t: Tensor, batch: int, width: int, aligned: bool) -> int:
    """The row stride of a [batch, width] float32 operand whose rows are
    contiguous (16-byte aligned where `aligned`)."""
    _cuda_f32(name, t)
    if tuple(t.shape) != (batch, width) or (width > 1 and t.stride(1) != 1):
        raise ValueError(f"{name}: expected [{batch}, {width}] rows of stride 1, got "
                         f"{tuple(t.shape)} with strides {t.stride()}")
    stride = t.stride(0) if batch > 1 else width
    if aligned and (stride % 4 or t.data_ptr() % 16):
        raise ValueError(f"{name}: rows must start on 16-byte boundaries")
    return stride


def ssm_step_cuda(state: Tensor, x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                  D: Tensor, first: Tensor, commit: bool = True) -> Tensor:
    """y [batch, H, P] of one step, `state` [batch, H, P, N] advanced in
    place unless `commit` is False (see ssm.ssm_step_plain for the
    function). x [batch, H, P] may be a view with rows of any stride whose
    [H, P] block is contiguous; B and C [batch, N] views likewise, 16-byte
    aligned."""
    _cuda_f32("state", state)
    if state.dim() != 4 or not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError(f"state: expected a contiguous, aligned [batch, H, P, N], got {tuple(state.shape)}")
    batch, H, P, N = state.shape
    if N not in STATE_SIZES:
        raise ValueError(f"ssm_step: the state size N must be one of {STATE_SIZES}, got {N}")
    _cuda_f32("x", x)
    if tuple(x.shape) != (batch, H, P) or x.stride(2) != 1 or x.stride(1) != P:
        raise ValueError(f"x: expected [{batch}, {H}, {P}] with a contiguous [H, P] block, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    sx = x.stride(0) if batch > 1 else H * P
    sb = _rows("B", B, batch, N, aligned=True)
    sc = _rows("C", C, batch, N, aligned=True)
    for name, t, shape in (("dt", dt, (batch, H)), ("A", A, (H,)), ("D", D, (H,))):
        _cuda_f32(name, t)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got {tuple(t.shape)}")
    if first.dtype != torch.bool or tuple(first.shape) != (batch,) or not first.is_contiguous() \
            or first.device != state.device:
        raise ValueError(f"first: expected a contiguous [{batch}] bool on {state.device}")
    y = torch.empty((batch, H, P), dtype=torch.float32, device=state.device)
    status = load_library().launch_ssm_step(
        state.data_ptr(), x.data_ptr(), sx, dt.data_ptr(), A.data_ptr(), B.data_ptr(), sb,
        C.data_ptr(), sc, D.data_ptr(), first.data_ptr(), batch, H, P, N, int(commit),
        y.data_ptr(), torch.cuda.current_stream(state.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"ssm_step launch failed with cudaError {status}")
    LAUNCHES["ssm_step"] += 1
    return y
