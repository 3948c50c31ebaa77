"""On-device semantic-segmentation camera (port of carla_ppo_tpu/ops/rasterizer.py).

Emits 80x160 frames of CARLA's 13 class ids for a batch of envs, in two
passes, each with a hand-written CUDA kernel and a plain PyTorch version of
the same function beside it:

1. Ground pass. In the camera-rotated frame a ground pixel's world point is
   a static ray constant (a, b) = (t, -t * lateral), so the only per-env
   work outside the kernel is `prep_windows`: gather the 128-waypoint window
   and rotate it into that frame. Per row stripe (rows grouped by the
   waypoint-window length K they need, `_row_stripes`), every pixel finds
   its nearest window waypoint (first-match argmin), takes the Frenet
   lateral / along-track coordinates from that waypoint's payload and runs
   the 13-class road ladder. Kernel: `ground_pass_cuda`
   (csrc/ground_pass.cu); plain: `ground_pass_plain`.
2. Billboard composite. Roadside props and NPC slots are camera-facing
   rectangles; `prep_candidates` projects each to screen space and packs
   its depth and class into an int32 key, and per pixel
   best = min_n max(U[n, col], V[n, row]) picks the nearest covering
   candidate, drawn where it is nearer than the row-static ground depth.
   Kernel: `composite_cuda` (csrc/composite.cu); plain: `composite_plain`.

`render_batch` / `render_batch_with_ground` launch the kernels for CUDA
tensors and run the plain versions for CPU tensors; any other device
raises. The stripe plan and every class-ladder constant are the JAX
package's, so the two packages agree pixel for pixel up to float rounding.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.observations import wp_gather
from carla_ppo_tpu_torch.envs.types import PROP_STRIDE, EnvParams, EnvState, SegClass
from carla_ppo_tpu_torch.ops import rasterizer_cuda

IMAX = 2**31 - 1
IMIN = -(2**31)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Dashboard camera (reference mount x=1.6 z=1.7, fov 90)."""

    height: int = 80
    width: int = 160
    fov_deg: float = 90.0
    mount_forward: float = 1.6
    mount_height: float = 1.7
    pitch_deg: float = 0.0
    window: int = 128
    window_behind: int = 16
    render_props: bool = True
    row_stripes: bool = True

    @property
    def focal(self) -> float:
        return (self.width / 2.0) / math.tan(math.radians(self.fov_deg) / 2.0)


@dataclasses.dataclass(frozen=True)
class RoadStyle:
    """Widths (m) of the painted / paved bands around the centerline."""

    edge_line_width: float = 0.15
    center_line_half_width: float = 0.08
    center_dash_period: float = 4.0
    center_dash_duty: float = 0.5
    shoulder_width: float = 0.4
    sidewalk_width: float = 2.0


def _f32(x: float) -> float:
    return float(np.float32(x))


def style_constants(style: RoadStyle) -> tuple[float, ...]:
    """The ladder's 8 constants, rounded to float32 once on the host, in the
    order the CUDA launcher takes them."""
    return (
        _f32(style.edge_line_width / 2.0),
        _f32(style.center_line_half_width),
        _f32(style.center_dash_period),
        _f32(style.center_dash_period * style.center_dash_duty),
        _f32(style.shoulder_width),
        _f32(style.sidewalk_width),
        _f32(style.shoulder_width + style.sidewalk_width),
        _f32(25.0),
    )


# ---------------------------------------------------------------------------
# Static camera geometry (numpy, per CameraConfig)
# ---------------------------------------------------------------------------


def _row_geometry(cam: CameraConfig):
    """Per-row vertical ray component, sky flag and ground depth t."""
    v = np.arange(cam.height) + 0.5
    vert = (cam.height / 2.0 - v) / cam.focal + math.tan(math.radians(cam.pitch_deg))
    sky = vert >= -1e-6
    with np.errstate(divide="ignore"):
        t = np.where(sky, np.inf, cam.mount_height / np.maximum(-vert, 1e-12))
    return vert, sky, t


def _row_stripes(cam: CameraConfig, margin: float = 12.0):
    """(n_sky_rows, [(row_lo, row_hi, K), ...]): rows grouped by the smallest
    window length K (multiples of 8 from 24) whose ahead-span covers the
    row's ground depth plus a margin; breaks only on rows divisible by 4.
    The plan decides which waypoints a pixel may pick, so it is the JAX
    package's plan exactly."""
    _, sky, t = _row_geometry(cam)
    n_sky = int(sky.sum())
    if not cam.row_stripes:
        return n_sky, [(n_sky, cam.height, cam.window)]
    choices = sorted({k for k in range(24, cam.window + 1, 8)} | {cam.window})
    stripes = []
    lo, cur_k = n_sky, None
    for row in range(n_sky, cam.height):
        need = t[row] + margin
        k = next((k for k in choices if k - cam.window_behind >= need), cam.window)
        if cur_k is None:
            cur_k = k
        elif k != cur_k and row % 4 == 0:
            stripes.append((lo, row, cur_k))
            lo, cur_k = row, k
    if cur_k is not None:
        stripes.append((lo, cam.height, cur_k))
    return n_sky, stripes


@functools.lru_cache(maxsize=None)
def stripe_layout(cam: CameraConfig):
    """(plan, slab [2, ground_px] float32 numpy, sky_px): plan rows are
    (K, ground_offset, P) per stripe; slab holds each ground pixel's ray
    constants (a, b) = (t, -t * lateral) in natural pixel order."""
    n_sky, stripes = _row_stripes(cam)
    W, H, f = cam.width, cam.height, cam.focal
    plan, slabs, off = [], [], 0
    for row_lo, row_hi, K in stripes:
        u = np.arange(W) + 0.5
        v = np.arange(row_lo, row_hi) + 0.5
        lateral = (u[None, :] - W / 2.0) / f
        vert = (H / 2.0 - v[:, None]) / f + math.tan(math.radians(cam.pitch_deg))
        with np.errstate(divide="ignore"):
            t = np.where(vert >= -1e-6, 0.0, cam.mount_height / np.maximum(-vert, 1e-12))
        a = np.broadcast_to(t, (row_hi - row_lo, W)).reshape(-1)
        b = (-t * lateral).reshape(-1)
        slabs.append(np.stack([a, b]).astype(np.float32))
        plan.append((K, off, a.shape[0]))
        off += a.shape[0]
    slab = np.concatenate(slabs, axis=1) if slabs else np.zeros((2, 0), np.float32)
    return tuple(plan), slab, n_sky * W


@functools.lru_cache(maxsize=None)
def _device_layout(cam: CameraConfig, device: str):
    """Device copies of the static layout: (slab, stripes int32 [n, 3],
    sky_px, ground depth per row [H] float32 with inf on sky rows)."""
    plan, slab, sky_px = stripe_layout(cam)
    dev = torch.device(device)
    _, _, t = _row_geometry(cam)
    return (
        torch.as_tensor(slab, device=dev).contiguous(),
        torch.as_tensor(np.asarray(plan, np.int32).reshape(-1, 3), device=dev).contiguous(),
        sky_px,
        torch.as_tensor(t.astype(np.float32), device=dev).contiguous(),
    )


# ---------------------------------------------------------------------------
# Ground pass
# ---------------------------------------------------------------------------


def window_table(track) -> Tensor:
    """[capacity, 6] per-waypoint rows: pos.xy, fwd.xy, left / right width."""
    return torch.cat(
        [track.pos, track.fwd, track.left_width[:, None], track.right_width[:, None]], 1
    )


def prep_windows(states: EnvState, params: EnvParams, cam: CameraConfig) -> Tuple[Tensor, Tensor]:
    """Per-env camera-rotated waypoint windows (port of _prep_windows):
    (win_cols [B, K0, 8] with x, y in columns 0, 1; payload [B, 8, K0] =
    fx, fy, c_lat, c_along, kidx, lw, rw, 0)."""
    track = params.track
    dev = track.device
    K0 = cam.window
    ar = torch.arange(K0, dtype=torch.int32, device=dev)
    idxs = states.waypoint_idx[:, None] - cam.window_behind + ar[None, :]
    win = wp_gather(window_table(track), idxs, track.length, track.is_loop)  # [B, K0, 6]

    yaw = states.vehicle.yaw
    cy, sy = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    cam_x = states.vehicle.pos[:, 0:1] + cy * cam.mount_forward
    cam_y = states.vehicle.pos[:, 1:2] + sy * cam.mount_forward
    wlx = win[..., 0] - cam_x
    wly = win[..., 1] - cam_y
    wpx = cy * wlx + sy * wly
    wpy = -sy * wlx + cy * wly
    fpx = cy * win[..., 2] + sy * win[..., 3]
    fpy = -sy * win[..., 2] + cy * win[..., 3]
    c_lat = fpy * wpx - fpx * wpy
    c_along = -(wpx * fpx + wpy * fpy)
    idx0 = (states.waypoint_idx - cam.window_behind).to(torch.float32)
    kidx = idx0[:, None] + ar.to(torch.float32)[None, :]
    zeros = torch.zeros_like(wpx)
    win_cols = torch.stack([wpx, wpy] + [zeros] * 6, dim=2).contiguous()
    payload = torch.stack(
        [fpx, fpy, c_lat, c_along, kidx, win[..., 4], win[..., 5], zeros], dim=1
    ).contiguous()
    return win_cols, payload


def _classify_block(lat, s, dist, lw, rw, consts: tuple[float, ...]) -> Tensor:
    """The 13-class road ladder (port of rasterizer_pallas._classify_block)."""
    edge_half, center_half, period, dash_len, shoulder, sidewalk, side_outer, margin = consts
    on_road = (lat >= -rw) & (lat <= lw)
    edge_line = (torch.abs(lat - lw) <= edge_half) | (torch.abs(lat + rw) <= edge_half)
    dash_on = torch.remainder(s, period) < dash_len
    road_center = (lw - rw) / 2.0
    center_line = (torch.abs(lat - road_center) <= center_half) & dash_on
    off = torch.maximum(lat - lw, -rw - lat)
    is_shoulder = (off > 0.0) & (off <= shoulder)
    is_sidewalk = (off > shoulder) & (off <= side_outer)
    widest = torch.maximum(lw, rw)
    corridor = dist <= widest + shoulder + sidewalk + margin
    cls = torch.full(lat.shape, int(SegClass.VEGETATION), dtype=torch.int32, device=lat.device)
    cls = torch.where(is_sidewalk, int(SegClass.SIDEWALKS), cls)
    cls = torch.where(is_shoulder, int(SegClass.OTHER), cls)
    cls = torch.where(on_road, int(SegClass.ROADS), cls)
    cls = torch.where(on_road & center_line, int(SegClass.ROADLINES), cls)
    cls = torch.where(edge_line, int(SegClass.ROADLINES), cls)
    cls = torch.where(~corridor, int(SegClass.VEGETATION), cls)
    return cls.to(torch.int32)


def ground_pass_plain(
    win_cols: Tensor,
    payload: Tensor,
    slab: Tensor,
    stripes: Tensor,
    sky_px: int,
    hw: int,
    consts: tuple[float, ...],
    env_chunk: int = 64,
) -> Tensor:
    """Plain PyTorch version of the ground-pass kernel: the same function,
    [B, hw] int32, evaluated as [chunk, K, P] tensors per stripe."""
    B = win_cols.shape[0]
    out = torch.zeros((B, hw), dtype=torch.int32, device=win_cols.device)
    plan = [tuple(int(v) for v in row) for row in stripes.tolist()]
    for e0 in range(0, B, env_chunk):
        e1 = min(B, e0 + env_chunk)
        for K, off, P in plan:
            a = slab[0, off:off + P][None, None, :]
            b = slab[1, off:off + P][None, None, :]
            wx = win_cols[e0:e1, :K, 0][:, :, None]
            wy = win_cols[e0:e1, :K, 1][:, :, None]
            dx = a - wx
            dy = b - wy
            d2 = dx * dx + dy * dy  # [E, K, P]
            d2_min = d2.amin(dim=1, keepdim=True)
            kk = torch.arange(K, device=d2.device, dtype=torch.int64)[None, :, None]
            nearest = torch.where(d2 == d2_min, kk, K).amin(dim=1)  # first match
            idx = nearest[:, None, :].expand(-1, 7, -1)
            near = torch.gather(payload[e0:e1, :7, :K], 2, idx)  # exact fetch
            fx, fy, c_lat, c_along, kidx, lw, rw = near.unbind(1)
            a1, b1 = a[0], b[0]
            lat = b1 * fx - a1 * fy + c_lat
            s = kidx + a1 * fx + b1 * fy + c_along
            dist = torch.sqrt(torch.clamp(d2_min[:, 0, :], min=0.0))
            out[e0:e1, sky_px + off:sky_px + off + P] = _classify_block(
                lat, s, dist, lw, rw, consts
            )
    return out


def ground_pass(win_cols: Tensor, payload: Tensor, cam: CameraConfig, style: RoadStyle) -> Tensor:
    """[B, H*W] int32 ground classes: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    slab, stripes, sky_px, _ = _device_layout(cam, str(win_cols.device))
    hw = cam.height * cam.width
    consts = style_constants(style)
    if win_cols.device.type == "cuda":
        return rasterizer_cuda.ground_pass_cuda(win_cols, payload, slab, stripes, sky_px, hw, consts)
    if win_cols.device.type == "cpu":
        return ground_pass_plain(win_cols, payload, slab, stripes, sky_px, hw, consts)
    raise ValueError(f"no ground pass for device {win_cols.device}")


# ---------------------------------------------------------------------------
# Billboard composite
# ---------------------------------------------------------------------------


def _visible_props(states: EnvState, params: EnvParams, cam: CameraConfig):
    """Billboard candidates in each env's window: (pos [B, N, 2], cls [B, N],
    height [B, N], halfwidth [B, N]); N = 2 * window / PROP_STRIDE props +
    NUM_NPC_SLOTS vehicles (class NONE when inactive)."""
    track = params.track
    dev = track.device
    S = cam.window // PROP_STRIDE
    live = max(track.length // PROP_STRIDE, 1)
    slot0 = torch.div(states.waypoint_idx - cam.window_behind, PROP_STRIDE, rounding_mode="floor")
    slots = slot0[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    if track.is_loop:
        slot_idx = torch.remainder(slots, live)
    else:
        slot_idx = torch.clamp(slots, 0, live - 1)
    n_slots = track.prop_class.shape[0]
    comb = torch.cat(
        [
            track.pos[::PROP_STRIDE][:n_slots],
            track.fwd[::PROP_STRIDE][:n_slots],
            track.prop_class.to(torch.float32),
            track.prop_lateral,
            track.prop_height,
            track.prop_halfwidth,
        ],
        1,
    )  # [n_slots, 12]
    win = comb[slot_idx.long()]  # [B, S, 12]
    wpos, wfwd = win[..., 0:2], win[..., 2:4]
    pcls = win[..., 4:6].to(torch.int32)
    plat, phgt, phwd = win[..., 6:8], win[..., 8:10], win[..., 10:12]
    normal = torch.stack([-wfwd[..., 1], wfwd[..., 0]], -1)  # [B, S, 2]
    ppos = wpos[:, :, None, :] + normal[:, :, None, :] * plat[..., None]  # [B, S, 2, 2]
    B = states.batch_size
    b_pos = ppos.reshape(B, -1, 2)
    b_cls = pcls.reshape(B, -1)
    b_hgt = phgt.reshape(B, -1)
    b_hwd = phwd.reshape(B, -1)
    if not params.render_npc_billboards:
        return b_pos, b_cls, b_hgt, b_hwd

    M = states.npc_s.shape[1]
    L = float(track.length)
    if track.is_loop:
        npc_wp = torch.remainder(states.npc_s, L)
    else:
        npc_wp = torch.clamp(states.npc_s, 0.0, L - 1.0)
    npc_wp = npc_wp.to(torch.int32)
    nwpos = wp_gather(track.pos, npc_wp, track.length, track.is_loop)
    nwfwd = wp_gather(track.fwd, npc_wp, track.length, track.is_loop)
    n_normal = torch.stack([-nwfwd[..., 1], nwfwd[..., 0]], -1)
    npos = nwpos + n_normal * states.npc_lateral[..., None]
    active = torch.arange(M, device=dev) < params.num_npcs
    ncls = torch.where(active, int(SegClass.VEHICLES), int(SegClass.NONE)).to(torch.int32)
    return (
        torch.cat([b_pos, npos], 1),
        torch.cat([b_cls, ncls[None, :].expand(B, M)], 1),
        torch.cat([b_hgt, torch.full((B, M), 1.5, device=dev)], 1),
        torch.cat([b_hwd, torch.full((B, M), 0.95, device=dev)], 1),
    )


def billboard_scalars(states: EnvState, params: EnvParams, cam: CameraConfig):
    """Per-candidate screen-space scalars, each [B, N]: (u_c, hw_pix,
    v_top, v_bot, key int32, valid bool). The key packs the class id into
    the low 4 bits of the positive f32 forward depth."""
    b_pos, b_cls, b_hgt, b_hwd = _visible_props(states, params, cam)
    H, W, focal = cam.height, cam.width, cam.focal
    yaw = states.vehicle.yaw[:, None]
    c, s = torch.cos(yaw), torch.sin(yaw)
    cam_x = states.vehicle.pos[:, 0:1] + c * cam.mount_forward
    cam_y = states.vehicle.pos[:, 1:2] + s * cam.mount_forward
    tanp = math.tan(math.radians(cam.pitch_deg))
    rx = b_pos[..., 0] - cam_x
    ry = b_pos[..., 1] - cam_y
    f = rx * c + ry * s
    lft = rx * s + ry * (-c)
    valid = (b_cls != int(SegClass.NONE)) & (f > 0.5)
    f_safe = torch.clamp(f, min=0.5)
    u_c = W / 2.0 + focal * lft / f_safe
    hw_pix = torch.clamp(focal * b_hwd / f_safe, min=0.5)
    v_bot = H / 2.0 - focal * ((0.0 - cam.mount_height) / f_safe - tanp)
    v_top = H / 2.0 - focal * ((b_hgt - cam.mount_height) / f_safe - tanp)
    key = (f_safe.contiguous().view(torch.int32) & ~15) | b_cls
    return u_c, hw_pix, v_top, v_bot, key, valid


def prep_candidates(states: EnvState, params: EnvParams, cam: CameraConfig) -> Tensor:
    """Candidate rows [B, Npad, 8] float32 = (u_c, hw_pix, key bits, valid,
    v_top, v_bot, 0, 0), padded to a multiple of 8 with invalid rows (port
    of _prep_candidates)."""
    u_c, hw_pix, v_top, v_bot, key, valid = billboard_scalars(states, params, cam)
    B, N = u_c.shape
    zeros = torch.zeros_like(u_c)
    rows = torch.stack(
        [u_c, hw_pix, key.view(torch.float32), valid.to(torch.float32), v_top, v_bot, zeros, zeros],
        dim=2,
    )
    Npad = -(-N // 8) * 8
    if Npad != N:
        rows = torch.cat([rows, rows.new_zeros(B, Npad - N, 8)], 1)
    return rows.contiguous()


def composite_plain(
    rows: Tensor, depth_rows: Tensor, ground: Tensor, W: int, env_chunk: int = 32
) -> Tensor:
    """Plain PyTorch version of the composite kernel: the same function,
    [B, H*W] int32, as the [chunk, N, H, W] min-max contraction."""
    B, N, _ = rows.shape
    H = depth_rows.shape[0]
    dev = rows.device
    u = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    imax = torch.tensor(IMAX, dtype=torch.int32, device=dev)
    imin = torch.tensor(IMIN, dtype=torch.int32, device=dev)
    out = torch.empty_like(ground)
    for e0 in range(0, B, env_chunk):
        e1 = min(B, e0 + env_chunk)
        r = rows[e0:e1]
        uc, hw, vt, vb = r[..., 0:1], r[..., 1:2], r[..., 4:5], r[..., 5:6]
        key = r[..., 2].contiguous().view(torch.int32)[..., None]
        ok = (r[..., 3] > 0.0)[..., None]
        U = torch.where(ok & (torch.abs(u - uc) <= hw), key, imax)  # [E, N, W]
        V = torch.where((v >= vt) & (v <= vb), imin, imax)  # [E, N, H]
        best = torch.maximum(U[:, :, None, :], V[:, :, :, None]).amin(dim=1)  # [E, H, W]
        best_d = (best & ~15).view(torch.float32)
        visible = best_d < depth_rows[None, :, None]
        g = ground[e0:e1].view(-1, H, W)
        out[e0:e1] = torch.where(visible, best & 15, g).reshape(e1 - e0, H * W)
    return out


def composite(rows: Tensor, ground: Tensor, cam: CameraConfig) -> Tensor:
    """Billboards over flat ground frames: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _, _, _, depth_rows = _device_layout(cam, str(rows.device))
    if rows.device.type == "cuda":
        return rasterizer_cuda.composite_cuda(rows, depth_rows, ground, cam.width)
    if rows.device.type == "cpu":
        return composite_plain(rows, depth_rows, ground, cam.width)
    raise ValueError(f"no composite for device {rows.device}")


# ---------------------------------------------------------------------------
# Batch entry points
# ---------------------------------------------------------------------------


def render_batch_with_ground(
    states: EnvState,
    params: EnvParams,
    cam: CameraConfig = CameraConfig(),
    style: RoadStyle = RoadStyle(),
) -> Tuple[Tensor, Tensor]:
    """([B, H, W] rich frames, [B, H, W] ground-only frames) int32."""
    B = states.batch_size
    win_cols, payload = prep_windows(states, params, cam)
    ground = ground_pass(win_cols, payload, cam, style)
    rich = ground
    if cam.render_props:
        rich = composite(prep_candidates(states, params, cam), ground, cam)
    return rich.view(B, cam.height, cam.width), ground.view(B, cam.height, cam.width)


def render_batch(
    states: EnvState,
    params: EnvParams,
    cam: CameraConfig = CameraConfig(),
    style: RoadStyle = RoadStyle(),
) -> Tensor:
    """[B, H, W] int32 seg frames for an env batch."""
    return render_batch_with_ground(states, params, cam, style)[0]


def seg_to_obs(cls: Tensor) -> Tensor:
    """Class ids -> float [..., H, W, 1] in [0, 1] (class / 12)."""
    return (cls.to(torch.float32) / 12.0)[..., None]
