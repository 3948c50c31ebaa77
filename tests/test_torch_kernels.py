"""The camera's kernels and their plain PyTorch versions, without JAX.

On the CPU: each plain version against an explicit per-pixel Python loop on
small crafted inputs (ties, sky prefix, stripe boundaries, uncovered and
overlapping billboards, the pose-fed window fetch and rotation), and the
kernels' edge cases: 128 billboard candidates (four 32-bit mask words),
coverage edges exactly on pixel centres, equal keys, an env with no valid
candidate, a frame width that is not a multiple of 4, stripes whose pixel counts are not multiples of 32, duplicated
waypoints and windows shorter than the scan's unroll; the wrappers refuse
sizes beyond the kernels' shared-memory tables. On a CUDA
card (`gpu` marker, skipped without one): each CUDA kernel against its
plain version, bit for bit, on the crafted inputs and on a 256-env batch
driven around the track with props; the pose-fed kernel also against the
ground-pass kernel; the ground-pass kernel on unaligned cameras, a banked
route batch and an odd batch size; the composite's scalar pixel loop on
an odd width and on frames off 16-byte alignment; and the render dispatch counting one
launch of each kernel per frame batch. The composite's depth-and-sky mode
(the RGB camera's) is held the same way: its plain version against the
loop oracle on the CPU, its kernel against the plain version, classes,
depth bits and sky, on the card.

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


def _crafted_ground_plan(seed, K0, plan, sky_px, row_width=None):
    """B=3 envs over a crafted stripe plan [(K, P), ...]: exact d2 ties
    (waypoint 2 repeated at 5 and 6, 19 at 20 where K0 allows; env 2's
    window is one point K0 times, so every pixel's d2 ties on every k and
    k = 0 must win) and pixels exactly on tied points. With row_width, the
    rays' forward component a is constant over each row of that many
    pixels, as a rigid camera's is (the kernel's row-shared scan)."""
    rng = np.random.default_rng(seed)
    B = 3
    win = np.zeros((B, K0, 8), np.float32)
    win[:, :, 0] = rng.uniform(0, 30, size=(B, K0))
    win[:, :, 1] = rng.uniform(-5, 5, size=(B, K0))
    for src, dups in ((2, (5, 6)), (19, (20,))):
        for d in dups:
            if d < K0:
                win[:2, d, :2] = win[:2, src, :2]
    win[2, :, :2] = win[2, 0, :2]
    payload = np.zeros((B, 8, K0), np.float32)
    payload[:, 0] = 1.0
    payload[:, 1] = rng.normal(0, 0.05, size=(B, K0))
    payload[:, 2] = rng.normal(0, 2, size=(B, K0))
    payload[:, 3] = rng.normal(0, 2, size=(B, K0))
    payload[:, 4] = np.arange(K0)[None, :] + rng.integers(-16, 900, size=(B, 1))
    payload[:, 5] = rng.uniform(1.5, 3.5, size=(B, K0))
    payload[:, 6] = rng.uniform(1.5, 3.5, size=(B, K0))
    offsets = np.cumsum([0] + [P for _, P in plan])
    stripes = np.array([[K, off, P] for (K, P), off in zip(plan, offsets)], np.int32)
    ground_px = int(offsets[-1])
    slab = np.zeros((2, ground_px), np.float32)
    slab[1] = rng.uniform(-8, 8, size=ground_px)
    on_first, on_last = win[0, min(2, K0 - 1), :2], win[1, min(19, K0 - 1), :2]
    if row_width is None:
        slab[0] = rng.uniform(0, 30, size=ground_px)
        slab[:, 3], slab[:, ground_px - 1] = on_first, on_last
    else:
        slab[0] = np.repeat(rng.uniform(0, 30, size=ground_px // row_width), row_width)
        slab[0, :row_width], slab[1, 3] = on_first
        slab[0, -row_width:], slab[1, -1] = on_last
    return win, payload, slab, stripes, sky_px, sky_px + ground_px


# Stripe pixel counts that are not multiples of 32 (nor of 4), K from the
# whole window down to below the k loop's unroll, odd sky prefixes, and
# rows of 12 pixels with a shared forward ray component.
GROUND_EDGE_CASES = {
    "ragged_stripes": lambda: _crafted_ground_plan(5, 24, [(24, 37), (9, 161), (3, 70), (24, 5)], 7),
    "tiny_window": lambda: _crafted_ground_plan(6, 2, [(2, 45), (1, 33)], 3),
    "row_shared_rays": lambda: _crafted_ground_plan(7, 32, [(32, 36), (17, 180), (5, 84)], 12,
                                                    row_width=12),
}


@pytest.mark.parametrize("case", sorted(GROUND_EDGE_CASES))
def test_plain_ground_pass_edge_cases(case):
    win, payload, slab, stripes, sky_px, hw = GROUND_EDGE_CASES[case]()
    got = R.ground_pass_plain(torch.as_tensor(win), torch.as_tensor(payload), torch.as_tensor(slab),
                              torch.as_tensor(stripes), sky_px, hw, CONSTS, env_chunk=2)
    want = _loop_ground(win, payload, slab, stripes, sky_px, hw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, :sky_px] == 0).all() and len(np.unique(want[:, sky_px:])) >= 2


EDGE_CAMERA = dict(height=12, width=20)


def _edge_depth_rows(W: int = EDGE_CAMERA["width"]) -> np.ndarray:
    """Ground depth per row of the 12-row edge-case camera at width W (inf on
    sky rows)."""
    return R._row_geometry(R.CameraConfig(**dict(EDGE_CAMERA, width=W)))[2].astype(np.float32)


def _keys(depth, cls) -> np.ndarray:
    """Candidate keys as float32 bits: depth with the class in its low 4 bits."""
    depth = np.asarray(depth, np.float32)
    return ((depth.view(np.int32) & ~15) | np.asarray(cls, np.int32)).astype(np.int32).view(np.float32)


def _random_candidates(rng, B, N, H, W):
    rows = np.zeros((B, N, 8), np.float32)
    rows[..., 0] = rng.uniform(-2, W + 2, size=(B, N))
    rows[..., 1] = rng.uniform(0.5, 4.0, size=(B, N))
    rows[..., 2] = _keys(rng.uniform(1.0, 60.0, size=(B, N)), rng.integers(1, 13, size=(B, N)))
    rows[..., 3] = (rng.random((B, N)) > 0.1).astype(np.float32)
    rows[..., 4] = rng.uniform(-2, H, size=(B, N))
    rows[..., 5] = rows[..., 4] + rng.uniform(0.5, 8.0, size=(B, N))
    return rows


def _crafted_composite_n128(seed=3):
    """B=2, N=128 candidates, all four 32-bit mask words in use; the nearest
    candidate, n=127 (the last bit of the fourth word), covers columns
    7..12 of rows 2..8."""
    rng = np.random.default_rng(seed)
    H, W = EDGE_CAMERA["height"], EDGE_CAMERA["width"]
    rows = _random_candidates(rng, 2, 128, H, W)
    rows[:, 127, :6] = (10.0, 3.0, _keys(0.75, 5), 1.0, 2.0, 9.0)
    ground = rng.integers(0, 13, size=(2, H * W)).astype(np.int32)
    return rows, _edge_depth_rows(), ground, W


def _crafted_composite_boundaries(seed=4):
    """B=3, N=72 (three mask words, the last one partial). Column edges
    |c + .5 - u_c| = hw_pix and row edges v_top, v_bot = r + .5 fall exactly
    on pixel centres (every value is exact in float32, so `<=` decides);
    equal keys on different rectangles and equal depths with different
    classes; an empty row span; a rectangle over the whole frame, behind the
    near rows' ground; env 2 has no valid candidate."""
    rng = np.random.default_rng(seed)
    H, W = EDGE_CAMERA["height"], EDGE_CAMERA["width"]
    B, N = 3, 72
    rows = _random_candidates(rng, B, N, H, W)
    n_exact = 48
    rows[:, :n_exact, 0] = 0.5 * rng.integers(-2, 2 * W + 2, size=(B, n_exact))
    rows[:, :n_exact, 1] = 0.5 * rng.integers(1, 7, size=(B, n_exact))
    rows[:, :n_exact, 4] = rng.integers(-1, H, size=(B, n_exact)) + 0.5
    rows[:, :n_exact, 5] = rows[:, :n_exact, 4] + rng.integers(0, 6, size=(B, n_exact))
    # u_c +- hw_pix = m + .25 +- (n + .25): one edge on a pixel centre, one between.
    rows[:, 48:56, 0] = rng.integers(2, W - 2, size=(B, 8)) + 0.25
    rows[:, 48:56, 1] = rng.integers(0, 3, size=(B, 8)) + 0.25
    rows[:, 60, :6] = (9.5, 2.0, _keys(3.0, 7), 1.0, 3.5, 8.5)
    rows[:, 61, :6] = (12.5, 2.0, _keys(3.0, 7), 1.0, 5.5, 10.5)  # the same key
    rows[:, 62, :6] = (11.0, 1.5, _keys(3.0, 2), 1.0, 4.5, 9.5)  # the same depth, class 2
    rows[:, 63, :6] = (4.5, 3.0, _keys(0.8, 9), 1.0, 6.5, 5.5)  # v_top > v_bot: no row
    rows[:, 64, :6] = (10.0, 40.0, _keys(25.0, 11), 1.0, -5.0, 40.0)  # whole frame, far
    rows[2, :, 3] = 0.0
    ground = rng.integers(0, 13, size=(B, H * W)).astype(np.int32)
    return rows, _edge_depth_rows(), ground, W


def _crafted_composite_odd_width(seed=5):
    """B=2, N=40 on a 12x18 frame: a width that is not a multiple of 4, so
    the kernel takes its scalar pixel loop; the nearest candidate, n=39,
    covers columns 7..12 of rows 2..8."""
    rng = np.random.default_rng(seed)
    H, W = EDGE_CAMERA["height"], 18
    rows = _random_candidates(rng, 2, 40, H, W)
    rows[:, 39, :6] = (10.0, 3.0, _keys(0.75, 5), 1.0, 2.0, 9.0)
    ground = rng.integers(0, 13, size=(2, H * W)).astype(np.int32)
    return rows, _edge_depth_rows(W), ground, W


COMPOSITE_EDGE_CASES = {"n128": _crafted_composite_n128, "boundaries": _crafted_composite_boundaries,
                        "odd_width": _crafted_composite_odd_width}


def _check_composite_edge_case(case, got, rows, ground, W):
    if case in ("n128", "odd_width"):
        assert (got[:, 2 * W + 7:2 * W + 13] == 5).all()  # the last candidate wins there
    else:
        np.testing.assert_array_equal(got[2], ground[2])  # no valid candidate
    assert (got[:2] != ground[:2]).any()


@pytest.mark.parametrize("case", sorted(COMPOSITE_EDGE_CASES))
def test_plain_composite_edge_cases(case):
    rows, depth, ground, W = COMPOSITE_EDGE_CASES[case]()
    got = R.composite_plain(torch.as_tensor(rows), torch.as_tensor(depth), torch.as_tensor(ground), W,
                            env_chunk=2).numpy()
    np.testing.assert_array_equal(got, _loop_composite(rows, depth, ground, W))
    _check_composite_edge_case(case, got, rows, ground, W)


def _loop_composite_depth_sky(rows, depth, ground, W):
    """(classes, depth, sky) of the depth-and-sky mode by the loop: the
    billboard's depth where it is visible, else the row's ground depth; sky
    on rows of infinite ground depth where no billboard is visible."""
    B, N, _ = rows.shape
    H = depth.shape[0]
    cls = _loop_composite(rows, depth, ground, W)
    dep = np.repeat(depth[None, :], W, axis=0).T.reshape(-1)[None].repeat(B, 0).copy()
    sky = np.isinf(dep)
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
                    dep[b, r * W + c] = bd
                    sky[b, r * W + c] = False
    return cls, dep, sky


DEPTH_SKY_CASES = dict(COMPOSITE_EDGE_CASES, crafted=_crafted_composite)


def _assert_depth_sky_equal(got, want):
    """Classes, depth bit patterns and sky all equal."""
    cls, dep, sky = (np.asarray(x.cpu()) if isinstance(x, torch.Tensor) else x for x in got)
    np.testing.assert_array_equal(cls, want[0])
    np.testing.assert_array_equal(dep.view(np.int32), np.asarray(want[1], np.float32).view(np.int32))
    np.testing.assert_array_equal(sky, want[2])


@pytest.mark.parametrize("case", sorted(DEPTH_SKY_CASES))
def test_plain_composite_depth_sky_matches_loop(case):
    rows, depth, ground, W = DEPTH_SKY_CASES[case]()
    got = R.composite_plain(torch.as_tensor(rows), torch.as_tensor(depth), torch.as_tensor(ground), W,
                            env_chunk=2, return_depth_sky=True)
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.bool
    want = _loop_composite_depth_sky(rows, depth, ground, W)
    _assert_depth_sky_equal(got, want)
    assert want[2].any() and (~want[2]).any() and np.isfinite(want[1]).any()


@pytest.mark.parametrize("kernel, what", [("composite", "candidates"),
                                          ("composite_depth_sky", "candidates"),
                                          ("ground_pass", "window"),
                                          ("ground_pass", "stripes"), ("ground_pass_pose", "window"),
                                          ("ground_pass_pose", "stripes")])
def test_cuda_wrappers_refuse_oversize(kernel, what):
    """Sizes beyond the kernels' shared-memory tables raise a ValueError that
    names the limit, before anything is launched."""
    before = dict(RC.LAUNCHES)
    K0 = RC.MAX_WINDOW + 1 if what == "window" else 128
    n_stripes = RC.MAX_STRIPES + 1 if what == "stripes" else 5
    stripes = torch.zeros(n_stripes, 3, dtype=torch.int32)
    if kernel.startswith("composite"):
        limit = RC.MAX_CANDIDATES
        fn = RC.composite_cuda if kernel == "composite" else RC.composite_depth_sky_cuda
        call = lambda: fn(torch.zeros(2, limit + 1, 8), torch.zeros(80),  # noqa: E731
                          torch.zeros(2, 12800, dtype=torch.int32), 160)
    elif kernel == "ground_pass":
        limit = RC.MAX_WINDOW if what == "window" else RC.MAX_STRIPES
        call = lambda: RC.ground_pass_cuda(torch.zeros(2, K0, 8), torch.zeros(2, 8, K0),  # noqa: E731
                                           torch.zeros(2, 6400), stripes, 6400, 12800, CONSTS)
    else:
        limit = RC.MAX_WINDOW if what == "window" else RC.MAX_STRIPES
        call = lambda: RC.ground_pass_pose_cuda(  # noqa: E731
            torch.zeros(2, dtype=torch.int32), torch.zeros(1200, 8), torch.zeros(2, 8), K0,
            torch.zeros(2, 6400), stripes, 6400, 12800, CONSTS)
    with pytest.raises(ValueError, match=f"between 1 and {limit}"):
        call()
    assert RC.LAUNCHES == before


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
    assert RC.LAUNCHES == {"ground_pass": 1, "ground_pass_pose": 0, "composite": 1,
                           "composite_depth_sky": 0}
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
    assert RC.LAUNCHES == {"ground_pass": 1, "ground_pass_pose": 0, "composite": 1,
                           "composite_depth_sky": 0}
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GROUND_EDGE_CASES))
def test_ground_edge_cases_on_card(cuda_device, case):
    win, payload, slab, stripes, sky_px, hw = GROUND_EDGE_CASES[case]()
    w, p, s, st = _cuda(win, payload, slab, stripes, device=cuda_device)
    got = RC.ground_pass_cuda(w, p, s, st, sky_px, hw, CONSTS)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), _loop_ground(win, payload, slab, stripes, sky_px, hw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(COMPOSITE_EDGE_CASES))
def test_composite_edge_cases_on_card(cuda_device, case):
    rows, depth, ground, W = COMPOSITE_EDGE_CASES[case]()
    r, d, g = _cuda(rows, depth, ground, device=cuda_device)
    got = RC.composite_cuda(r, d, g, W)
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got, _loop_composite(rows, depth, ground, W))
    _check_composite_edge_case(case, got, rows, ground, W)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(COMPOSITE_EDGE_CASES))
def test_composite_unaligned_frames_on_card(cuda_device, case):
    """Ground frames that start 4 bytes past a 16-byte boundary (a
    contiguous view at storage offset 1) take the scalar pixel loop at any
    width; it must agree with the loop oracle too."""
    rows, depth, ground, W = COMPOSITE_EDGE_CASES[case]()
    r, d = _cuda(rows, depth, device=cuda_device)
    buf = torch.zeros(ground.size + 1, dtype=torch.int32, device=cuda_device)
    g = buf[1:].view(ground.shape)
    g.copy_(torch.as_tensor(ground))
    assert g.is_contiguous() and g.data_ptr() % 16 != 0
    got = RC.composite_cuda(r, d, g, W)
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got, _loop_composite(rows, depth, ground, W))
    _check_composite_edge_case(case, got, rows, ground, W)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(DEPTH_SKY_CASES))
def test_composite_depth_sky_cases_on_card(cuda_device, case):
    """The depth-and-sky kernel against the loop oracle on the crafted and
    edge cases, with the frames aligned (the 16-byte pixel pass where the
    width allows) and 4 bytes off alignment (the scalar loop)."""
    rows, depth, ground, W = DEPTH_SKY_CASES[case]()
    want = _loop_composite_depth_sky(rows, depth, ground, W)
    r, d, g = _cuda(rows, depth, ground, device=cuda_device)
    _assert_depth_sky_equal(RC.composite_depth_sky_cuda(r, d, g, W), want)
    buf = torch.zeros(ground.size + 1, dtype=torch.int32, device=cuda_device)
    g1 = buf[1:].view(ground.shape)
    g1.copy_(torch.as_tensor(ground))
    _assert_depth_sky_equal(RC.composite_depth_sky_cuda(r, d, g1, W), want)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_composite_depth_sky_matches_plain_on_card(cuda_device):
    """A 256-env driven batch with props: classes, depth bits and sky equal
    the plain version's, and the classes equal the class-only kernel's."""
    s, p = _card_batch(cuda_device)
    cam = R.CameraConfig()
    win_cols, payload = R.prep_windows(s, p, cam)
    ground = R.ground_pass(win_cols, payload, cam, R.RoadStyle())
    rows = R.prep_candidates(s, p, cam)
    depth = R._device_layout(cam, str(rows.device))[3]
    plain = R.composite_plain(rows, depth, ground, cam.width, return_depth_sky=True)
    before = RC.LAUNCHES["composite_depth_sky"]
    got = R.composite_depth_sky(rows, ground, cam)
    torch.cuda.synchronize()
    assert RC.LAUNCHES["composite_depth_sky"] == before + 1
    _assert_depth_sky_equal(got, [x.cpu().numpy() for x in plain])
    assert torch.equal(got[0], RC.composite_cuda(rows, depth, ground, cam.width))
    assert bool(got[2].any()) and bool(torch.isfinite(got[1]).any())


@pytest.mark.gpu
def test_render_rgb_batch_launches_kernels_on_card(cuda_device):
    """render_rgb_batch: one ground pass and one depth-and-sky composite per
    batch, [B, H, W, 3] in [0, 1], equal to the plain versions' frames on
    the same card tensors shaded the same way."""
    s, p = _card_batch(cuda_device, n=64, steps=2)
    cam = R.CameraConfig()
    RC.reset_launch_counts()
    rgb = R.render_rgb_batch(s, p)
    torch.cuda.synchronize()
    assert RC.LAUNCHES == {"ground_pass": 1, "ground_pass_pose": 0, "composite": 0,
                           "composite_depth_sky": 1}
    assert rgb.shape == (64, 80, 160, 3) and float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
    win_cols, payload = R.prep_windows(s, p, cam)
    slab, stripes, sky_px, depth = R._device_layout(cam, str(win_cols.device))
    ground = R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, 12800, CONSTS)
    plain = R.composite_plain(R.prep_candidates(s, p, cam), depth, ground, cam.width,
                              return_depth_sky=True)
    assert torch.equal(rgb, R._shade_rgb(*plain, cam))


@pytest.mark.gpu
@pytest.mark.parametrize("contract", ["dash_80x160", "chase_180x320", "banked_route"])
def test_single_env_renders_on_card(cuda_device, contract):
    """A batch of one, as the interactive envs render it: render_semantic
    (and, on the dashcam, render_rgb's depth-and-sky composite) launch the
    kernels once each and equal the plain versions, 0 mismatched pixels."""
    from carla_ppo_tpu_torch.envs import route_env, route_planner
    from carla_ppo_tpu_torch.envs.types import map_tensors
    from carla_ppo_tpu_torch.utils.device import make_generator

    if contract == "banked_route":
        bank = route_planner.make_route_bank(route_planner.make_town(seed=0), n_routes=4,
                                             device=cuda_device)
        p = route_env.route_env_params(bank)
        g = make_generator(0, cuda_device)
        s = route_env.reset(p, g, batch=1)
        for _ in range(24):
            s, _ = route_env.autoreset_step(s, torch.tensor([[0.0, 1.0]], device=cuda_device), p, g,
                                            obs_fn=None)
    else:
        s, p = _card_batch(cuda_device, n=8, steps=24)
        s = map_tensors(lambda t: t[5:6], s)
    cam = (R.CameraConfig(height=180, width=320, mount_forward=-5.5, mount_height=2.8,
                          pitch_deg=-15.0) if contract == "chase_180x320" else R.CameraConfig())
    win_cols, payload = R.prep_windows(s, p, cam)
    slab, stripes, sky_px, depth = R._device_layout(cam, str(win_cols.device))
    hw = cam.height * cam.width
    ground = R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, hw, CONSTS)
    rows = R.prep_candidates(s, p, cam)
    plain = R.composite_plain(rows, depth, ground, cam.width)
    RC.reset_launch_counts()
    got = R.render_semantic(s, p, cam)
    torch.cuda.synchronize()
    assert RC.LAUNCHES == {"ground_pass": 1, "ground_pass_pose": 0, "composite": 1,
                           "composite_depth_sky": 0}
    assert got.shape == (cam.height, cam.width)
    assert int((got.view(1, -1) != plain).sum()) == 0
    if contract == "dash_80x160":
        RC.reset_launch_counts()
        rgb = R.render_rgb(s, p, cam)
        torch.cuda.synchronize()
        assert RC.LAUNCHES["composite_depth_sky"] == 1 and RC.LAUNCHES["ground_pass"] == 1
        want = R._shade_rgb(*R.composite_plain(rows, depth, ground, cam.width,
                                               return_depth_sky=True), cam)
        assert torch.equal(rgb, want[0])
