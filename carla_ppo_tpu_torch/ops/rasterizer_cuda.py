"""CUDA wrappers of the camera's kernels (sources in ../csrc).

- `ground_pass_cuda`       <- rasterizer_pallas.render_batch_pallas_v5 (and
  v4, v3d, v3c: the same function under other TPU layouts)
- `ground_pass_pose_cuda`  <- rasterizer_pallas.render_batch_pallas_v6
- `composite_cuda`         <- rasterizer_pallas.composite_billboards_pallas
- `composite_depth_sky_cuda` <- the same kernel's depth-and-sky mode, which
  the RGB camera needs (on the TPU the XLA _composite_billboards_flat with
  return_depth_sky=True; the Pallas composite is class-only)

Each wrapper checks the kernels' size limits (at most MAX_CANDIDATES
billboard candidates, a window of at most MAX_WINDOW waypoints, at most
MAX_STRIPES stripes), device, dtype, shape and contiguity and raises on
anything else, allocates its output with torch.empty, launches on the
current stream, raises on a non-zero launch status, and adds one to its
entry in LAUNCHES per launch. Their plain PyTorch versions live in
ops/rasterizer.py (`ground_pass_plain`, `ground_pass_pose_plain`,
`composite_plain`, which also takes return_depth_sky); the dispatch there takes the plain version only for
CPU tensors.
"""

from __future__ import annotations

import torch
from torch import Tensor

from carla_ppo_tpu_torch.utils.cuda_build import load_library

# The kernels' shared-memory tables: kMaxCandidates in csrc/composite.cu,
# kMaxWindow and kMaxStripes in csrc/ground_common.cuh.
MAX_CANDIDATES = 128
MAX_WINDOW = 256
MAX_STRIPES = 64

# Launch counts per kernel; callers zero them with reset_launch_counts().
LAUNCHES = {"ground_pass": 0, "ground_pass_pose": 0, "composite": 0, "composite_depth_sky": 0}


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


def _check_limit(kernel: str, what: str, n: int, limit: int) -> None:
    if not 1 <= n <= limit:
        raise ValueError(f"{kernel}: {what} must be between 1 and {limit}, got {n}")


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
    _check_limit("ground_pass", "the window length K0", K0, MAX_WINDOW)
    _check_limit("ground_pass", "the number of stripes", n_stripes, MAX_STRIPES)
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


def ground_pass_pose_cuda(
    starts: Tensor,
    table: Tensor,
    pose: Tensor,
    window: int,
    slab: Tensor,
    stripes: Tensor,
    sky_px: int,
    hw: int,
    style_consts: tuple[float, ...],
) -> Tensor:
    """[B, hw] int32 class ids from the wrap-baked table and per-env poses
    (see rasterizer.ground_pass_pose_plain for the function)."""
    B = starts.shape[0]
    M = table.shape[0]
    n_stripes = stripes.shape[0]
    ground_px = slab.shape[1]
    _check_limit("ground_pass_pose", "the window length", window, MAX_WINDOW)
    _check_limit("ground_pass_pose", "the number of stripes", n_stripes, MAX_STRIPES)
    _check("starts", starts, torch.int32, (B,))
    _check("table", table, torch.float32, (M, 8))
    _check("pose", pose, torch.float32, (B, 8))
    _check("slab", slab, torch.float32, (2, ground_px))
    _check("stripes", stripes, torch.int32, (n_stripes, 3))
    if sky_px + ground_px != hw:
        raise ValueError(f"sky_px {sky_px} + ground_px {ground_px} != hw {hw}")
    if len(style_consts) != 8:
        raise ValueError("style_consts must hold 8 floats")
    out = torch.empty((B, hw), dtype=torch.int32, device=starts.device)
    lib = load_library()
    status = lib.launch_ground_pass_pose(
        starts.data_ptr(), table.data_ptr(), M, pose.data_ptr(), window, slab.data_ptr(),
        stripes.data_ptr(), n_stripes, sky_px, ground_px, hw, B, *style_consts,
        out.data_ptr(), torch.cuda.current_stream(starts.device).cuda_stream,
    )
    _raise_on(status, "ground_pass_pose")
    LAUNCHES["ground_pass_pose"] += 1
    return out


def composite_cuda(rows: Tensor, depth_rows: Tensor, ground: Tensor, W: int) -> Tensor:
    """[B, H*W] int32: billboards composited over `ground` (see
    rasterizer.composite_plain for the function)."""
    B, N, _ = rows.shape
    H = depth_rows.shape[0]
    _check_limit("composite", "the number of candidates N", N, MAX_CANDIDATES)
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


def composite_depth_sky_cuda(
    rows: Tensor, depth_rows: Tensor, ground: Tensor, W: int
) -> tuple[Tensor, Tensor, Tensor]:
    """(classes [B, H*W] int32, depth [B, H*W] float32, sky [B, H*W] bool):
    the composite's depth-and-sky mode (see rasterizer.composite_plain
    with return_depth_sky=True for the function)."""
    B, N, _ = rows.shape
    H = depth_rows.shape[0]
    _check_limit("composite_depth_sky", "the number of candidates N", N, MAX_CANDIDATES)
    _check("rows", rows, torch.float32, (B, N, 8))
    _check("depth_rows", depth_rows, torch.float32, (H,))
    _check("ground", ground, torch.int32, (B, H * W))
    out = torch.empty_like(ground)
    depth = torch.empty((B, H * W), dtype=torch.float32, device=ground.device)
    sky = torch.empty((B, H * W), dtype=torch.bool, device=ground.device)  # one byte, 0 or 1
    lib = load_library()
    status = lib.launch_composite_depth_sky(
        rows.data_ptr(), depth_rows.data_ptr(), ground.data_ptr(), B, N, H, W,
        out.data_ptr(), depth.data_ptr(), sky.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _raise_on(status, "composite_depth_sky")
    LAUNCHES["composite_depth_sky"] += 1
    return out, depth, sky
