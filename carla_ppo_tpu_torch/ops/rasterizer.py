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

`render_batch` / `render_batch_with_ground` (one shared track) and
`render_batch_banked` (a track bank, each env on its row `route_id`: the
route and lap-bank envs) launch the kernels for CUDA tensors and run the
plain versions for CPU tensors; any other device raises. Only the prep
reads the track, so both take the same two kernels on any camera (aligned
or not) and any batch size.

`render_rgb_batch` is the shaded pseudo-RGB camera (the VAE's RGB
source): the same ground pass, then the composite's depth-and-sky mode
(`composite_depth_sky`: kernel `composite_depth_sky_cuda`, the same
csrc/composite.cu; plain `composite_plain(..., return_depth_sky=True)`),
then the palette, depth fog and sky gradient in plain torch (`_shade_rgb`,
elementwise as in the JAX package). It takes a shared track or a bank.
`render_semantic` and `render_rgb` are the single-env forms (a batch of
one, as the interactive envs hold it), and `render_rgb_and_semantic` gives
both from one render (cli.collect_data).

`render_batch_pose` is a third ground pass for a shared track: the window
fetch and the camera rotation move into the kernel (`ground_pass_pose`,
csrc/ground_pass_pose.cu), fed by a wrap-baked table and one 8-float pose
per env (`prep_pose`); its output equals `ground_pass`'s.

The stripe plan and every class-ladder constant are the JAX package's, so
the two packages agree pixel for pixel up to float rounding.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from carla_ppo_tpu_torch.envs.observations import env_track
from carla_ppo_tpu_torch.envs.types import PROP_STRIDE, EnvParams, EnvState, SegClass
from carla_ppo_tpu_torch.ops import rasterizer_cuda
from carla_ppo_tpu_torch.utils import profiling

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
    """[capacity, 6] per-waypoint rows (pos.xy, fwd.xy, left / right width);
    [R, capacity, 6] for a bank."""
    return torch.cat(
        [track.pos, track.fwd, track.left_width[..., None], track.right_width[..., None]], -1
    )


def _camera_pose(states: EnvState, cam: CameraConfig) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(cy, sy, cam_x, cam_y), each [B]: the camera's heading and position."""
    yaw = states.vehicle.yaw
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cam_x = states.vehicle.pos[:, 0] + cy * cam.mount_forward
    cam_y = states.vehicle.pos[:, 1] + sy * cam.mount_forward
    return cy, sy, cam_x, cam_y


def _rotate_windows(win: Tensor, cy, sy, cam_x, cam_y, idx0: Tensor) -> Tuple[Tensor, Tensor]:
    """Window rows [B, K0, >= 6] (x, y, fx, fy, lw, rw) into the camera
    frame: (win_cols [B, K0, 8], payload [B, 8, K0]); pose values [B, 1].
    csrc/ground_pass_pose.cu repeats these operations in this order."""
    K0 = win.shape[1]
    wlx = win[..., 0] - cam_x
    wly = win[..., 1] - cam_y
    wpx = cy * wlx + sy * wly
    wpy = -sy * wlx + cy * wly
    fpx = cy * win[..., 2] + sy * win[..., 3]
    fpy = -sy * win[..., 2] + cy * win[..., 3]
    c_lat = fpy * wpx - fpx * wpy
    c_along = -(wpx * fpx + wpy * fpy)
    kidx = idx0 + torch.arange(K0, dtype=torch.float32, device=win.device)[None, :]
    zeros = torch.zeros_like(wpx)
    win_cols = torch.stack([wpx, wpy] + [zeros] * 6, dim=2).contiguous()
    payload = torch.stack(
        [fpx, fpy, c_lat, c_along, kidx, win[..., 4], win[..., 5], zeros], dim=1
    ).contiguous()
    return win_cols, payload


def prep_windows(states: EnvState, params: EnvParams, cam: CameraConfig) -> Tuple[Tensor, Tensor]:
    """Per-env camera-rotated waypoint windows (port of _prep_windows), from
    the shared track or each env's bank row: (win_cols [B, K0, 8] with x, y
    in columns 0, 1; payload [B, 8, K0] = fx, fy, c_lat, c_along, kidx,
    lw, rw, 0)."""
    with profiling.span("camera.prep_windows"):
        track = params.track
        K0 = cam.window
        ar = torch.arange(K0, dtype=torch.int32, device=track.device)
        idxs = states.waypoint_idx[:, None] - cam.window_behind + ar[None, :]
        win = env_track(track, states.route_id).gather(window_table(track), idxs)  # [B, K0, 6]
        cy, sy, cam_x, cam_y = (x[:, None] for x in _camera_pose(states, cam))
        idx0 = (states.waypoint_idx - cam.window_behind).to(torch.float32)[:, None]
        return _rotate_windows(win, cy, sy, cam_x, cam_y, idx0)


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
    with profiling.span("camera.ground_pass"):
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
    et = env_track(track, states.route_id)
    dev = track.device
    S = cam.window // PROP_STRIDE
    slot0 = torch.div(states.waypoint_idx - cam.window_behind, PROP_STRIDE, rounding_mode="floor")
    slots = slot0[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    if et.rows is None:
        live = max(track.length // PROP_STRIDE, 1)
    else:
        live = torch.clamp(torch.div(et.length, PROP_STRIDE, rounding_mode="floor"), min=1)[:, None]
    if track.is_loop:
        slot_idx = torch.remainder(slots, live)
    else:
        slot_idx = torch.clamp(torch.clamp(slots, min=0), max=live - 1)
    n_slots = track.prop_slots
    comb = torch.cat(
        [
            track.pos[..., ::PROP_STRIDE, :][..., :n_slots, :],
            track.fwd[..., ::PROP_STRIDE, :][..., :n_slots, :],
            track.prop_class.to(torch.float32),
            track.prop_lateral,
            track.prop_height,
            track.prop_halfwidth,
        ],
        -1,
    )  # [n_slots, 12] ([R, n_slots, 12] for a bank)
    win = comb[slot_idx.long()] if et.rows is None else comb[et.rows[:, None], slot_idx.long()]
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
    L = float(track.length) if et.rows is None else et.length.to(torch.float32)[:, None]
    if track.is_loop:
        npc_wp = torch.remainder(states.npc_s, L)
    else:
        npc_wp = torch.clamp(torch.clamp(states.npc_s, min=0.0), max=L - 1.0)
    npc_wp = npc_wp.to(torch.int32)
    nwpos = et.gather(track.pos, npc_wp)
    nwfwd = et.gather(track.fwd, npc_wp)
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
    with profiling.span("camera.prep_candidates"):
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
    rows: Tensor, depth_rows: Tensor, ground: Tensor, W: int, env_chunk: int = 32,
    return_depth_sky: bool = False,
):
    """Plain PyTorch version of the composite kernel: the same function,
    [B, H*W] int32, as the [chunk, N, H, W] min-max contraction. With
    return_depth_sky, (classes, depth [B, H*W] float32, sky [B, H*W] bool):
    the billboard's depth where it is visible, else the row's ground depth;
    sky on rows of infinite ground depth (the sky rows) where no billboard
    is visible."""
    B, N, _ = rows.shape
    H = depth_rows.shape[0]
    dev = rows.device
    u = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    imax = torch.tensor(IMAX, dtype=torch.int32, device=dev)
    imin = torch.tensor(IMIN, dtype=torch.int32, device=dev)
    out = torch.empty_like(ground)
    if return_depth_sky:
        out_depth = torch.empty(ground.shape, dtype=torch.float32, device=dev)
        out_sky = torch.empty(ground.shape, dtype=torch.bool, device=dev)
        sky_rows = torch.isinf(depth_rows)[None, :, None]
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
        if return_depth_sky:
            d = torch.where(visible, best_d, depth_rows[None, :, None])
            out_depth[e0:e1] = d.reshape(e1 - e0, H * W)
            out_sky[e0:e1] = (sky_rows & ~visible).reshape(e1 - e0, H * W)
    if return_depth_sky:
        return out, out_depth, out_sky
    return out


def composite(rows: Tensor, ground: Tensor, cam: CameraConfig) -> Tensor:
    """Billboards over flat ground frames: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    with profiling.span("camera.composite"):
        _, _, _, depth_rows = _device_layout(cam, str(rows.device))
        if rows.device.type == "cuda":
            return rasterizer_cuda.composite_cuda(rows, depth_rows, ground, cam.width)
        if rows.device.type == "cpu":
            return composite_plain(rows, depth_rows, ground, cam.width)
    raise ValueError(f"no composite for device {rows.device}")


def composite_depth_sky(rows: Tensor, ground: Tensor, cam: CameraConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """(classes, depth, sky), each [B, H*W]: the composite's depth-and-sky
    mode, the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    with profiling.span("camera.composite"):
        _, _, _, depth_rows = _device_layout(cam, str(rows.device))
        if rows.device.type == "cuda":
            return rasterizer_cuda.composite_depth_sky_cuda(rows, depth_rows, ground, cam.width)
        if rows.device.type == "cpu":
            return composite_plain(rows, depth_rows, ground, cam.width, return_depth_sky=True)
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
    """([B, H, W] rich frames, [B, H, W] ground-only frames) int32, from the
    shared track or, for a bank, each env's row."""
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
    """[B, H, W] int32 seg frames for an env batch on one shared track."""
    if params.track.banked:
        raise ValueError("params.track is a bank: use render_batch_banked")
    return render_batch_with_ground(states, params, cam, style)[0]


def render_batch_banked(
    states: EnvState,
    params: EnvParams,
    cam: CameraConfig = CameraConfig(),
    style: RoadStyle = RoadStyle(),
) -> Tensor:
    """[B, H, W] int32 seg frames for a batch over a track bank (route /
    lap_bank): env i renders its row `states.route_id[i]`. The kernels are
    track-agnostic; only the prep reads the bank."""
    if not params.track.banked:
        raise ValueError("params.track is one track: use render_batch")
    return render_batch_with_ground(states, params, cam, style)[0]


# ---------------------------------------------------------------------------
# Pose-fed ground pass (port of render_batch_pallas_v6)
# ---------------------------------------------------------------------------


def prep_pose(states: EnvState, params: EnvParams, cam: CameraConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """O(B) prep of the pose-fed ground pass (port of _prep_pose_v6):
    (starts [B] int32, table [M, 8] float32, pose [B, 8] float32).

    `table` bakes the track's wrap (loops) or clamp (open tracks) into
    M = capacity + window_behind + window rows, row r holding waypoint
    r - window_behind (x, y, fx, fy, lw, rw, 0, 0), so env b's window is
    rows [starts[b], starts[b] + window). `pose` = (cos yaw, sin yaw,
    cam_x, cam_y, waypoint_idx - window_behind, 0, 0, 0), with the same
    torch operations as prep_windows."""
    track = params.track
    if track.banked:
        raise ValueError("the pose-fed ground pass takes one shared track, not a bank")
    dev = track.device
    behind = cam.window_behind
    m = track.capacity + behind + cam.window
    j = torch.arange(m, dtype=torch.int32, device=dev) - behind
    if track.is_loop:
        rows = torch.remainder(j, track.length)
    else:
        rows = torch.clamp(j, 0, track.length - 1)
    table = torch.nn.functional.pad(window_table(track)[rows.long()], (0, 2)).contiguous()
    idx0 = states.waypoint_idx - behind  # unwrapped: the s coordinate
    start = torch.remainder(idx0, track.length) if track.is_loop else idx0
    starts = (start + behind).to(torch.int32).contiguous()
    cy, sy, cam_x, cam_y = _camera_pose(states, cam)
    zeros = torch.zeros_like(cy)
    pose = torch.stack([cy, sy, cam_x, cam_y, idx0.to(torch.float32), zeros, zeros, zeros], 1)
    return starts, table, pose.contiguous()


def pose_windows(starts: Tensor, table: Tensor, pose: Tensor, window: int) -> Tuple[Tensor, Tensor]:
    """prep_windows' (win_cols, payload) from prep_pose's outputs."""
    ar = torch.arange(window, dtype=torch.int64, device=table.device)
    win = table[starts.long()[:, None] + ar[None, :]]  # [B, K0, 8]
    cy, sy, cam_x, cam_y, idx0 = (pose[:, c:c + 1] for c in range(5))
    return _rotate_windows(win, cy, sy, cam_x, cam_y, idx0)


def ground_pass_pose_plain(
    starts: Tensor, table: Tensor, pose: Tensor, window: int, slab: Tensor, stripes: Tensor,
    sky_px: int, hw: int, consts: tuple[float, ...],
) -> Tensor:
    """Plain PyTorch version of the pose-fed kernel: the window fetch and
    rotation in torch, then ground_pass_plain. [B, hw] int32."""
    win_cols, payload = pose_windows(starts, table, pose, window)
    return ground_pass_plain(win_cols, payload, slab, stripes, sky_px, hw, consts)


def ground_pass_pose(
    starts: Tensor, table: Tensor, pose: Tensor, cam: CameraConfig, style: RoadStyle
) -> Tensor:
    """[B, H*W] int32 ground classes from prep_pose's outputs: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    slab, stripes, sky_px, _ = _device_layout(cam, str(table.device))
    hw = cam.height * cam.width
    consts = style_constants(style)
    if table.device.type == "cuda":
        return rasterizer_cuda.ground_pass_pose_cuda(
            starts, table, pose, cam.window, slab, stripes, sky_px, hw, consts
        )
    if table.device.type == "cpu":
        return ground_pass_pose_plain(starts, table, pose, cam.window, slab, stripes, sky_px, hw, consts)
    raise ValueError(f"no pose-fed ground pass for device {table.device}")


def render_batch_pose(
    states: EnvState,
    params: EnvParams,
    cam: CameraConfig = CameraConfig(),
    style: RoadStyle = RoadStyle(),
) -> Tensor:
    """[B, H*W] int32 ground frames (no billboards) of a shared-track batch
    through the pose-fed kernel; equal to ground_pass(prep_windows(...))
    on loops, and on open tracks wherever no window reaches before the
    first waypoint (there it reads the first waypoint, not the padded
    tail)."""
    return ground_pass_pose(*prep_pose(states, params, cam), cam, style)


def seg_to_obs(cls: Tensor) -> Tensor:
    """Class ids -> float [..., H, W, 1] in [0, 1] (class / 12)."""
    return (cls.to(torch.float32) / 12.0)[..., None]


# ---------------------------------------------------------------------------
# The RGB camera
# ---------------------------------------------------------------------------

# CARLA's 13-class palette, RGB in [0, 1].
_PALETTE = (
    (0, 0, 0), (70, 70, 70), (190, 153, 153), (72, 0, 90), (220, 20, 60),
    (153, 153, 153), (157, 234, 50), (128, 64, 128), (244, 35, 232),
    (107, 142, 35), (0, 0, 255), (102, 102, 156), (220, 220, 0),
)
SEG_PALETTE = torch.tensor(_PALETTE, dtype=torch.float32) / 255.0
_HAZE = (0.74, 0.78, 0.82)
_ZENITH = (0.35, 0.52, 0.78)
NOISE_STD = 0.02  # texture noise, per channel and pixel


@functools.lru_cache(maxsize=None)
def _shade_constants(cam: CameraConfig, device: str) -> Tuple[Tensor, Tensor, Tensor]:
    """(palette [13, 3], haze [3], sky colour per pixel [H*W, 3]) on
    `device`; the sky gradient runs from haze at the horizon to zenith blue,
    by the pixel's vertical ray component in float32."""
    dev = torch.device(device)
    v = torch.arange(cam.height, dtype=torch.float32).repeat_interleave(cam.width) + 0.5
    pitch = torch.deg2rad(torch.tensor(cam.pitch_deg, dtype=torch.float32))
    vert = (cam.height / 2.0 - v) / cam.focal + torch.tan(pitch)
    sky_t = torch.clamp(vert / 0.5, 0.0, 1.0)[:, None]
    haze = torch.tensor(_HAZE, dtype=torch.float32)
    zenith = torch.tensor(_ZENITH, dtype=torch.float32)
    sky_rgb = haze * (1.0 - sky_t) + zenith * sky_t
    return SEG_PALETTE.to(dev), haze.to(dev), sky_rgb.to(dev)


def seg_to_rgb(cls: Tensor) -> Tensor:
    """Palette render, [..., H, W] -> [..., H, W, 3] float in [0, 1] (a
    gather of palette rows; the JAX package's one-hot matmul gives the same
    float32 values)."""
    return SEG_PALETTE.to(cls.device)[cls.long()]


def _shade_rgb(cls: Tensor, depth: Tensor, sky: Tensor, cam: CameraConfig,
               noise: Tensor | torch.Generator | None = None) -> Tensor:
    """Palette + depth fog + sky gradient: [B, H*W] classes, depth and sky
    -> [B, H, W, 3] float32. `noise`: a generator for N(0, 1) texture noise
    (scaled by NOISE_STD, then clipped to [0, 1]), or the [B, H, W, 3]
    standard-normal draw itself."""
    B = cls.shape[0]
    palette, haze, sky_rgb = _shade_constants(cam, str(cls.device))
    base = palette[cls.long()]  # [B, P, 3]
    fog = torch.clamp(torch.where(sky, torch.zeros_like(depth), depth) / 250.0, 0.0, 1.0)[..., None]
    ground_rgb = base * (1.0 - fog) + haze * fog
    rgb = torch.where(sky[..., None], sky_rgb, ground_rgb).view(B, cam.height, cam.width, 3)
    if noise is not None:
        if isinstance(noise, torch.Generator):
            noise = torch.randn(rgb.shape, generator=noise, device=rgb.device)
        rgb = torch.clamp(rgb + NOISE_STD * noise, 0.0, 1.0)
    return rgb


def _static_depth_sky(cam: CameraConfig, device: str) -> Tuple[Tensor, Tensor]:
    """Per-pixel (depth [H*W] float32, sky [H*W] bool) of the ground alone:
    the row's ground depth (inf on sky rows) and the sky rows."""
    _, _, _, depth_rows = _device_layout(cam, device)
    depth = depth_rows.repeat_interleave(cam.width)
    return depth, torch.isinf(depth)


def _rgb_and_classes(
    states: EnvState, params: EnvParams, cam: CameraConfig, style: RoadStyle,
    noise: Tensor | torch.Generator | None,
) -> Tuple[Tensor, Tensor]:
    """([B, H, W, 3] RGB, [B, H*W] int32 classes): the ground pass, the
    composite's depth-and-sky mode, then the shade."""
    win_cols, payload = prep_windows(states, params, cam)
    ground = ground_pass(win_cols, payload, cam, style)
    if cam.render_props:
        cls, depth, sky = composite_depth_sky(prep_candidates(states, params, cam), ground, cam)
    else:
        depth0, sky0 = _static_depth_sky(cam, str(ground.device))
        cls, depth, sky = ground, depth0.expand_as(ground), sky0.expand_as(ground)
    return _shade_rgb(cls, depth, sky, cam, noise), cls


def render_rgb_batch(
    states: EnvState,
    params: EnvParams,
    cam: CameraConfig = CameraConfig(),
    style: RoadStyle = RoadStyle(),
    noise: Tensor | torch.Generator | None = None,
) -> Tensor:
    """[B, H, W, 3] shaded pseudo-RGB frames in [0, 1], from the shared
    track or each env's bank row: the ground pass, the composite's
    depth-and-sky mode, then the shade. `noise` as in _shade_rgb."""
    return _rgb_and_classes(states, params, cam, style, noise)[0]


def _one_env(state: EnvState) -> None:
    if state.batch_size != 1:
        raise ValueError(f"expected a batch of one env, got {state.batch_size}")


def render_semantic(
    state: EnvState, params: EnvParams, cam: CameraConfig = CameraConfig(),
    style: RoadStyle = RoadStyle(),
) -> Tensor:
    """One env's seg frame [H, W] int32 from a batch of one: render_batch,
    or render_batch_banked on the env's row when params.track is a bank."""
    _one_env(state)
    render = render_batch_banked if params.track.banked else render_batch
    return render(state, params, cam, style)[0]


def render_rgb(
    state: EnvState, params: EnvParams, cam: CameraConfig = CameraConfig(),
    style: RoadStyle = RoadStyle(), generator: Tensor | torch.Generator | None = None,
) -> Tensor:
    """One env's shaded pseudo-RGB frame [H, W, 3] float32 in [0, 1] from a
    batch of one (the shared track or the env's bank row). `generator`
    draws the texture noise; a [1, H, W, 3] standard-normal tensor is taken
    as the draw itself."""
    _one_env(state)
    return render_rgb_batch(state, params, cam, style, generator)[0]


def render_rgb_and_semantic(
    state: EnvState, params: EnvParams, cam: CameraConfig = CameraConfig(),
    style: RoadStyle = RoadStyle(), noise: Tensor | torch.Generator | None = None,
) -> Tuple[Tensor, Tensor]:
    """One env's (RGB frame [H, W, 3], seg frame [H, W] int32) from a batch
    of one, in one render: the classes the RGB frame was shaded from are
    the seg frame (the depth-and-sky composite's classes equal the
    class-only composite's)."""
    _one_env(state)
    rgb, cls = _rgb_and_classes(state, params, cam, style, noise)
    return rgb[0], cls[0].view(cam.height, cam.width)
