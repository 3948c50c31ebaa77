"""CUDA wrappers of the camera's two kernels (sources in ../csrc).

- `ground_pass_cuda`  <- rasterizer_pallas.render_batch_pallas_v5
- `composite_cuda`    <- rasterizer_pallas.composite_billboards_pallas

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its output with torch.empty, launches on the
current stream, raises on a non-zero launch status, and adds one to its
entry in LAUNCHES per launch. Their plain PyTorch versions live in
ops/rasterizer.py (`ground_pass_plain`, `composite_plain`); the dispatch
there takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch
from torch import Tensor

from carla_ppo_tpu_torch.utils.cuda_build import load_library

# Launch counts per kernel; callers zero them with reset_launch_counts().
LAUNCHES = {"ground_pass": 0, "composite": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if not isinstance(t, Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(status: int, kernel: str) -> None:
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {status}")


def ground_pass_cuda(
    win_cols: Tensor,
    payload: Tensor,
    slab: Tensor,
    stripes: Tensor,
    sky_px: int,
    hw: int,
    style_consts: tuple[float, ...],
) -> Tensor:
    """[B, hw] int32 class ids from the prepped windows (see
    rasterizer.ground_pass_plain for the function)."""
    B, K0, _ = win_cols.shape
    n_stripes = stripes.shape[0]
    ground_px = slab.shape[1]
    _check("win_cols", win_cols, torch.float32, (B, K0, 8))
    _check("payload", payload, torch.float32, (B, 8, K0))
    _check("slab", slab, torch.float32, (2, ground_px))
    _check("stripes", stripes, torch.int32, (n_stripes, 3))
    if sky_px + ground_px != hw:
        raise ValueError(f"sky_px {sky_px} + ground_px {ground_px} != hw {hw}")
    if len(style_consts) != 8:
        raise ValueError("style_consts must hold 8 floats")
    out = torch.empty((B, hw), dtype=torch.int32, device=win_cols.device)
    lib = load_library()
    status = lib.launch_ground_pass(
        win_cols.data_ptr(), payload.data_ptr(), slab.data_ptr(), stripes.data_ptr(),
        n_stripes, sky_px, ground_px, hw, B, K0, *style_consts,
        out.data_ptr(), torch.cuda.current_stream(win_cols.device).cuda_stream,
    )
    _raise_on(status, "ground_pass")
    LAUNCHES["ground_pass"] += 1
    return out


def composite_cuda(rows: Tensor, depth_rows: Tensor, ground: Tensor, W: int) -> Tensor:
    """[B, H*W] int32: billboards composited over `ground` (see
    rasterizer.composite_plain for the function)."""
    B, N, _ = rows.shape
    H = depth_rows.shape[0]
    _check("rows", rows, torch.float32, (B, N, 8))
    _check("depth_rows", depth_rows, torch.float32, (H,))
    _check("ground", ground, torch.int32, (B, H * W))
    out = torch.empty_like(ground)
    lib = load_library()
    status = lib.launch_composite(
        rows.data_ptr(), depth_rows.data_ptr(), ground.data_ptr(), B, N, H, W,
        out.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _raise_on(status, "composite")
    LAUNCHES["composite"] += 1
    return out
