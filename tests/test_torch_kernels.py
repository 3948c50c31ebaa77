"""The camera's kernels and their plain PyTorch versions, without JAX.

On the CPU: each plain version against an explicit per-pixel Python loop on
small crafted inputs (ties, sky prefix, stripe boundaries, uncovered and
overlapping billboards, the pose-fed window fetch and rotation). On a CUDA
card (`gpu` marker, skipped without one): each CUDA kernel against its
plain version, bit for bit, on the crafted inputs and on a 256-env batch
driven around the track with props; the pose-fed kernel also against the
ground-pass kernel; the ground-pass kernel on unaligned cameras, a banked
route batch and an odd batch size; and the render dispatch counting one
launch of each kernel per frame batch.

This module imports neither JAX nor the JAX package, so on a machine
without JAX the card tests run with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from carla_ppo_tpu_torch.ops import rasterizer as R
from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC

CONSTS = R.style_constants(R.RoadStyle())


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: the hand-written kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _crafted_ground(seed=0):
    """B=3 envs, K0=16 window points with duplicated (tied) points, two
    stripes (K=8 then K=16), 4 sky pixels in front."""
    rng = np.random.default_rng(seed)
    B, K0 = 3, 16
    win = np.zeros((B, K0, 8), np.float32)
    win[:, :, 0] = rng.uniform(0, 30, size=(B, K0))
    win[:, :, 1] = rng.uniform(-5, 5, size=(B, K0))
    win[:, 5, :2] = win[:, 2, :2]  # exact ties: the first index must win
    win[:, 11, :2] = win[:, 9, :2]
    payload = np.zeros((B, 8, K0), np.float32)
    payload[:, 0] = 1.0
    payload[:, 1] = rng.normal(0, 0.05, size=(B, K0))
    payload[:, 2] = rng.normal(0, 2, size=(B, K0))
    payload[:, 3] = rng.normal(0, 2, size=(B, K0))
    payload[:, 4] = np.arange(K0)[None, :] + rng.integers(-16, 900, size=(B, 1))
    payload[:, 5] = rng.uniform(1.5, 3.5, size=(B, K0))
    payload[:, 6] = rng.uniform(1.5, 3.5, size=(B, K0))
    P = 40
    slab = np.zeros((2, 2 * P), np.float32)
    slab[0] = rng.uniform(0, 30, size=2 * P)
    slab[1] = rng.uniform(-8, 8, size=2 * P)
    slab[:, 3] = win[0, 2, :2]  # a pixel exactly on the tied point
    stripes = np.array([[8, 0, P], [16, P, P]], np.int32)
    return win, payload, slab, stripes, 4, 4 + 2 * P


def _loop_ground(win, payload, slab, stripes, sky_px, hw):
    edge, center, period, dash, sh, sw, side_outer, margin = (np.float32(c) for c in CONSTS)
    f = np.float32
    B = win.shape[0]
    out = np.zeros((B, hw), np.int32)
    for b in range(B):
        for p in range(hw - sky_px):
            K = [k for k, off, _ in stripes if p >= off][-1]
            a, bb = slab[0, p], slab[1, p]
            d2 = [(a - win[b, k, 0]) * (a - win[b, k, 0]) + (bb - win[b, k, 1]) * (bb - win[b, k, 1])
                  for k in range(K)]
            i = int(np.argmin(d2))  # numpy argmin: first occurrence
            fx, fy, clat, calong, kidx, lw, rw = payload[b, :7, i]
            lat = bb * fx - a * fy + clat
            s = kidx + a * fx + bb * fy + calong
            dist = np.sqrt(max(d2[i], f(0)))
            on_road = -rw <= lat <= lw
            edge_line = abs(lat - lw) <= edge or abs(lat + rw) <= edge
            dash_on = f(math.fmod(s, period) + (period if math.fmod(s, period) < 0 else 0)) < dash
            center_line = abs(lat - (lw - rw) / f(2)) <= center and dash_on
            off = max(lat - lw, -rw - lat)
            cls = 9
            if side_outer >= off > sh:
                cls = 8
            if sh >= off > 0:
                cls = 3
            if on_road:
                cls = 7
            if on_road and center_line:
                cls = 6
            if edge_line:
                cls = 6
            if not dist <= max(lw, rw) + sh + sw + margin:
                cls = 9
            out[b, sky_px + p] = cls
    return out


def _crafted_pose(seed=2):
    """A wrap-baked table of M=40 rows, B=3 envs with K0=16 windows starting
    at rows 0, 7 and 24, poses with arbitrary headings; the crafted stripe
    plan and slab of _crafted_ground."""
    rng = np.random.default_rng(seed)
    M, K0 = 40, 16
    table = np.zeros((M, 8), np.float32)
    table[:, 0] = np.cumsum(rng.uniform(0.5, 1.5, size=M))
    table[:, 1] = rng.uniform(-3, 3, size=M)
    ang = rng.uniform(-0.4, 0.4, size=M)
    table[:, 2], table[:, 3] = np.cos(ang), np.sin(ang)
    table[:, 4] = rng.uniform(1.5, 3.5, size=M)
    table[:, 5] = rng.uniform(1.5, 3.5, size=M)
    starts = np.array([0, 7, 24], np.int32)
    yaw = rng.uniform(-0.5, 0.5, size=3).astype(np.float32)
    pose = np.zeros((3, 8), np.float32)
    pose[:, 0], pose[:, 1] = np.cos(yaw), np.sin(yaw)
    pose[:, 2] = table[starts + 4, 0] + rng.normal(0, 1, size=3)
    pose[:, 3] = table[starts + 4, 1] + rng.normal(0, 1, size=3)
    pose[:, 4] = np.array([-16, 5, 300], np.float32)
    _, _, slab, stripes, sky_px, hw = _crafted_ground()
    return starts, table, pose, K0, slab, stripes, sky_px, hw


def _loop_pose_windows(starts, table, pose, K0):
    """The window fetch and camera rotation, one float32 operation at a time."""
    B = starts.shape[0]
    win = np.zeros((B, K0, 8), np.float32)
    payload = np.zeros((B, 8, K0), np.float32)
    for b in range(B):
        cy, sy, cx, cyy, idx0 = pose[b, :5]
        for k in range(K0):
            x, y, fx, fy, lw, rw = table[starts[b] + k, :6]
            wlx, wly = x - cx, y - cyy
            wpx = cy * wlx + sy * wly
            wpy = -sy * wlx + cy * wly
            fpx = cy * fx + sy * fy
            fpy = -sy * fx + cy * fy
            win[b, k, :2] = wpx, wpy
            payload[b, :7, k] = (fpx, fpy, fpy * wpx - fpx * wpy, -(wpx * fpx + wpy * fpy),
                                 idx0 + np.float32(k), lw, rw)
    return win, payload


def test_plain_ground_pass_pose_matches_loop():
    starts, table, pose, K0, slab, stripes, sky_px, hw = _crafted_pose()
    got = R.ground_pass_pose_plain(
        torch.as_tensor(starts), torch.as_tensor(table), torch.as_tensor(pose), K0,
        torch.as_tensor(slab), torch.as_tensor(stripes), sky_px, hw, CONSTS,
    )
    win, payload = _loop_pose_windows(starts, table, pose, K0)
    want = _loop_ground(win, payload, slab, stripes, sky_px, hw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[:, sky_px:])) >= 3


def test_plain_ground_pass_matches_loop():
    win, payload, slab, stripes, sky_px, hw = _crafted_ground()
    got = R.ground_pass_plain(torch.as_tensor(win), torch.as_tensor(payload), torch.as_tensor(slab),
                              torch.as_tensor(stripes), sky_px, hw, CONSTS, env_chunk=2)
    want = _loop_ground(win, payload, slab, stripes, sky_px, hw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, :sky_px] == 0).all() and len(np.unique(want[:, sky_px:])) >= 3


def _crafted_composite(seed=1):
    """B=2, N=8 candidates (one invalid, two overlapping with different
    depths, one behind the ground), H=6, W=10."""
    rng = np.random.default_rng(seed)
    B, N, H, W = 2, 8, 6, 10
    rows = np.zeros((B, N, 8), np.float32)
    depth = rng.uniform(5.0, 40.0, size=N).astype(np.float32)
    depth[3] = 100.0  # behind every ground row below
    cls = rng.integers(1, 13, size=N)
    keys = (depth.view(np.int32) & ~15) | cls
    rows[:, :, 0] = rng.uniform(0, W, size=(B, N))
    rows[:, :, 1] = rng.uniform(0.5, 3.0, size=(B, N))
    rows[:, :, 2] = keys.astype(np.int32).view(np.float32)[None, :]
    rows[:, :, 3] = 1.0
    rows[:, 6, 3] = 0.0  # invalid
    rows[:, :, 4] = rng.uniform(-1, 3, size=(B, N))
    rows[:, :, 5] = rows[:, :, 4] + rng.uniform(0.5, 5, size=(B, N))
    rows[:, 1, :] = rows[:, 0, :]
    rows[:, 1, 2] = np.array((np.float32(depth[0] * 0.5).view(np.int32) & ~15) | 4, np.int32).view(np.float32)
    ground_depth = np.array([np.inf, np.inf, 60.0, 30.0, 12.0, 6.0], np.float32)
    ground = rng.integers(0, 13, size=(B, H * W)).astype(np.int32)
    return rows, ground_depth, ground, W


def _loop_composite(rows, depth, ground, W):
    B, N, _ = rows.shape
    H = depth.shape[0]
    out = ground.copy()
    for b in range(B):
        for r in range(H):
            for c in range(W):
                best = 2**31 - 1
                for n in range(N):
                    uc, hw, keyf, ok, vt, vb = rows[b, n, :6]
                    u, v = np.float32(c + 0.5), np.float32(r + 0.5)
                    if ok > 0 and abs(u - uc) <= hw and vt <= v <= vb:
                        best = min(best, int(np.array(keyf, np.float32).view(np.int32)))
                bd = np.array(best & ~15, np.int32).view(np.float32)
                if bd < depth[r]:
                    out[b, r * W + c] = best & 15
    return out


def test_plain_composite_matches_loop():
    rows, depth, ground, W = _crafted_composite()
    got = R.composite_plain(torch.as_tensor(rows), torch.as_tensor(depth), torch.as_tensor(ground), W,
                            env_chunk=1)
    want = _loop_composite(rows, depth, ground, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != ground).any()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda(*arrays, device):
    return [torch.as_tensor(a).to(device).contiguous() for a in arrays]


@pytest.mark.gpu
def test_crafted_cases_on_card(cuda_device):
    win, payload, slab, stripes, sky_px, hw = _crafted_ground()
    w, p, s, st = _cuda(win, payload, slab, stripes, device=cuda_device)
    got = RC.ground_pass_cuda(w, p, s, st, sky_px, hw, CONSTS)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), _loop_ground(win, payload, slab, stripes, sky_px, hw))
    rows, depth, ground, W = _crafted_composite()
    r, d, g = _cuda(rows, depth, ground, device=cuda_device)
    got = RC.composite_cuda(r, d, g, W)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), _loop_composite(rows, depth, ground, W))


def _card_batch(device, n=256, steps=24):
    from carla_ppo_tpu_torch.envs import lap_env
    from carla_ppo_tpu_torch.envs import track
    from carla_ppo_tpu_torch.envs.types import EnvParams
    from carla_ppo_tpu_torch.utils.device import make_generator

    p = EnvParams(track=track.make_lap_track(seed=0, props=True, device=device))
    g = make_generator(0, device)
    s = lap_env.reset(p, g, checkpoint_idx=torch.arange(n, device=device) * 37)
    for _ in range(steps):
        a = torch.rand(n, 2, generator=g, device=device)
        a[:, 0] = 2.0 * a[:, 0] - 1.0
        s, _ = lap_env.autoreset_step(s, a, p, g, obs_fn=None)
    return s, p


@pytest.mark.gpu
def test_ground_kernel_matches_plain_on_card(cuda_device):
    s, p = _card_batch(cuda_device)
    cam, style = R.CameraConfig(), R.RoadStyle()
    win_cols, payload = R.prep_windows(s, p, cam)
    slab, stripes, sky_px, _ = R._device_layout(cam, str(win_cols.device))
    plain = R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, 12800, CONSTS)
    before = RC.LAUNCHES["ground_pass"]
    got = R.ground_pass(win_cols, payload, cam, style)
    torch.cuda.synchronize()
    assert RC.LAUNCHES["ground_pass"] == before + 1
    assert int((got != plain).sum()) == 0


@pytest.mark.gpu
def test_composite_kernel_matches_plain_on_card(cuda_device):
    s, p = _card_batch(cuda_device)
    cam = R.CameraConfig()
    win_cols, payload = R.prep_windows(s, p, cam)
    ground = R.ground_pass(win_cols, payload, cam, R.RoadStyle())
    rows = R.prep_candidates(s, p, cam)
    depth = R._device_layout(cam, str(rows.device))[3]
    plain = R.composite_plain(rows, depth, ground, cam.width)
    before = RC.LAUNCHES["composite"]
    got = R.composite(rows, ground, cam)
    torch.cuda.synchronize()
    assert RC.LAUNCHES["composite"] == before + 1
    assert torch.equal(got, plain)
    assert bool((got != ground).any())


@pytest.mark.gpu
def test_render_batch_launches_both_kernels(cuda_device):
    s, p = _card_batch(cuda_device, n=64, steps=2)
    RC.reset_launch_counts()
    frames = R.render_batch(s, p)
    torch.cuda.synchronize()
    assert RC.LAUNCHES == {"ground_pass": 1, "ground_pass_pose": 0, "composite": 1}
    assert frames.shape == (64, 80, 160) and frames.device.type == "cuda"
    assert int(frames.min()) >= 0 and int(frames.max()) <= 12


@pytest.mark.gpu
def test_crafted_pose_case_on_card(cuda_device):
    starts, table, pose, K0, slab, stripes, sky_px, hw = _crafted_pose()
    st, t, ps, sl, sp = _cuda(starts, table, pose, slab, stripes, device=cuda_device)
    got = RC.ground_pass_pose_cuda(st, t, ps, K0, sl, sp, sky_px, hw, CONSTS)
    torch.cuda.synchronize()
    win, payload = _loop_pose_windows(starts, table, pose, K0)
    np.testing.assert_array_equal(got.cpu().numpy(), _loop_ground(win, payload, slab, stripes, sky_px, hw))


@pytest.mark.gpu
def test_pose_kernel_matches_plain_and_ground_pass_on_card(cuda_device):
    """The pose-fed kernel equals its plain version and the ground-pass
    kernel on prep_windows' windows, bit for bit."""
    s, p = _card_batch(cuda_device)
    cam, style = R.CameraConfig(), R.RoadStyle()
    starts, table, pose = R.prep_pose(s, p, cam)
    slab, stripes, sky_px, _ = R._device_layout(cam, str(table.device))
    plain = R.ground_pass_pose_plain(starts, table, pose, cam.window, slab, stripes, sky_px, 12800, CONSTS)
    before = dict(RC.LAUNCHES)
    got = R.render_batch_pose(s, p, cam, style)
    ground = R.ground_pass(*R.prep_windows(s, p, cam), cam, style)
    torch.cuda.synchronize()
    assert RC.LAUNCHES["ground_pass_pose"] == before["ground_pass_pose"] + 1
    assert int((got != plain).sum()) == 0
    assert int((got != ground).sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("camera", ["84x84", "spectator_180x320"])
def test_ground_kernel_unaligned_cameras_on_card(cuda_device, camera):
    kw = dict(height=84, width=84) if camera == "84x84" else dict(
        height=180, width=320, mount_forward=-5.5, mount_height=2.8, pitch_deg=-15.0)
    cam = R.CameraConfig(**kw)
    s, p = _card_batch(cuda_device)
    win_cols, payload = R.prep_windows(s, p, cam)
    slab, stripes, sky_px, _ = R._device_layout(cam, str(win_cols.device))
    hw = cam.height * cam.width
    plain = R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, hw, CONSTS)
    got = R.ground_pass(win_cols, payload, cam, R.RoadStyle())
    torch.cuda.synchronize()
    assert got.shape == (256, hw)
    assert int((got != plain).sum()) == 0


@pytest.mark.gpu
def test_ground_kernel_banked_route_batch_on_card(cuda_device):
    """A route bank with props: render_batch_banked launches both kernels,
    each equal to its plain version, and draws billboards."""
    from carla_ppo_tpu_torch.envs import route_env, route_planner
    from carla_ppo_tpu_torch.utils.device import make_generator

    bank = route_planner.make_route_bank(route_planner.make_town(seed=0), n_routes=16,
                                         capacity=1024, props=True, device=cuda_device)
    p = route_env.route_env_params(bank)
    g = make_generator(0, cuda_device)
    s = route_env.reset(p, g, batch=256)
    for _ in range(24):
        a = torch.rand(256, 2, generator=g, device=cuda_device)
        a[:, 0] = 0.4 * a[:, 0] - 0.2
        s, _ = route_env.autoreset_step(s, a, p, g, obs_fn=None)
    cam = R.CameraConfig()
    win_cols, payload = R.prep_windows(s, p, cam)
    slab, stripes, sky_px, depth = R._device_layout(cam, str(win_cols.device))
    ground_plain = R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, 12800, CONSTS)
    rows = R.prep_candidates(s, p, cam)
    rich_plain = R.composite_plain(rows, depth, ground_plain, cam.width)
    RC.reset_launch_counts()
    rich = R.render_batch_banked(s, p, cam)
    torch.cuda.synchronize()
    assert RC.LAUNCHES == {"ground_pass": 1, "ground_pass_pose": 0, "composite": 1}
    assert torch.equal(rich.view(256, -1), rich_plain)
    assert bool((rich_plain != ground_plain).any())


@pytest.mark.gpu
def test_ground_kernel_odd_batch_on_card(cuda_device):
    s, p = _card_batch(cuda_device, n=1000, steps=4)
    cam = R.CameraConfig()
    win_cols, payload = R.prep_windows(s, p, cam)
    slab, stripes, sky_px, _ = R._device_layout(cam, str(win_cols.device))
    plain = R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, 12800, CONSTS)
    got = R.ground_pass(win_cols, payload, cam, R.RoadStyle())
    torch.cuda.synchronize()
    assert got.shape == (1000, 12800)
    assert int((got != plain).sum()) == 0
