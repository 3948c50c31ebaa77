# Frozen copy of carla_ppo_tpu_torch/envs/track.py (commit cbdb1fb), the benchmark's
# reference: imports made local.
# It imports nothing of the program and is not edited when the program changes.
"""Host-side track construction (port of carla_ppo_tpu/envs/track.py).

The geometry is baked in numpy (float64) exactly as the JAX package does and
is cast to float32 at the tensor boundary, once, where the JAX package's
`jnp.asarray` (x64 off) casts it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from .types import PROP_STRIDE, RoadOption, SegClass, TrackData
from .device import resolve_device

_TURN_CURVATURE = 1.0 / 40.0
DEFAULT_HALF_WIDTH = 1.75


def _resample_polyline(points: np.ndarray, resolution: float, closed: bool) -> np.ndarray:
    if closed:
        points = np.vstack([points, points[:1]])
    seg_len = np.linalg.norm(np.diff(points, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg_len)])
    n = int(np.floor(s[-1] / resolution))
    targets = np.arange(n) * resolution
    return np.stack(
        [np.interp(targets, s, points[:, 0]), np.interp(targets, s, points[:, 1])], axis=1
    )


def _next_rows(pos: np.ndarray, closed: bool) -> np.ndarray:
    return np.roll(pos, -1, axis=0) if closed else np.vstack([pos[1:], pos[-1:]])


def _forward_vectors(pos: np.ndarray, closed: bool) -> np.ndarray:
    prv = np.roll(pos, 1, axis=0) if closed else np.vstack([pos[:1], pos[:-1]])
    fwd = _next_rows(pos, closed) - prv
    return fwd / np.maximum(np.linalg.norm(fwd, axis=1, keepdims=True), 1e-9)


def _curvature(pos: np.ndarray, fwd: np.ndarray, closed: bool) -> np.ndarray:
    yaw = np.arctan2(fwd[:, 1], fwd[:, 0])
    dyaw = np.diff(yaw, append=yaw[:1] if closed else yaw[-1:])
    dyaw = (dyaw + np.pi) % (2 * np.pi) - np.pi
    ds = np.linalg.norm(_next_rows(pos, closed) - pos, axis=1)
    return dyaw / np.maximum(ds, 1e-9)


def _maneuvers_from_curvature(kappa: np.ndarray) -> np.ndarray:
    m = np.full(kappa.shape, int(RoadOption.LANEFOLLOW), dtype=np.int32)
    m[kappa > _TURN_CURVATURE] = int(RoadOption.LEFT)
    m[kappa < -_TURN_CURVATURE] = int(RoadOption.RIGHT)
    return m


def _pad_to(arr: np.ndarray, capacity: int, fill) -> np.ndarray:
    if arr.shape[0] > capacity:
        raise ValueError(f"track length {arr.shape[0]} exceeds capacity {capacity}")
    pad = capacity - arr.shape[0]
    if pad == 0:
        return arr
    block = np.broadcast_to(np.asarray(fill, dtype=arr.dtype), (pad,) + arr.shape[1:])
    return np.concatenate([arr, block], axis=0)


def track_from_arrays(arrays: dict, device="cuda") -> TrackData:
    """TrackData from numpy arrays named like its fields (float32 / int32)."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    return TrackData(
        pos=t("pos", f32), fwd=t("fwd", f32), maneuver=t("maneuver", i32),
        left_width=t("left_width", f32), right_width=t("right_width", f32),
        length=int(arrays["length"]), is_loop=bool(arrays["is_loop"]),
        prop_class=t("prop_class", i32), prop_lateral=t("prop_lateral", f32),
        prop_height=t("prop_height", f32), prop_halfwidth=t("prop_halfwidth", f32),
    )


def bank_from_arrays(banks: Sequence[dict], device="cuda") -> TrackData:
    """A bank (leading track axis) from the numpy arrays of R tracks of one
    capacity and one `is_loop`; `length` becomes an [R] int32 tensor."""
    loops = {bool(a["is_loop"]) for a in banks}
    if len(loops) != 1:
        raise ValueError("a bank holds only loops or only open routes")
    stacked = {
        name: np.stack([a[name] for a in banks])
        for name in ("pos", "fwd", "maneuver", "left_width", "right_width", "prop_class",
                     "prop_lateral", "prop_height", "prop_halfwidth")
    }
    track = track_from_arrays(dict(stacked, length=0, is_loop=loops.pop()), device)
    lengths = np.asarray([int(a["length"]) for a in banks], np.int32)
    return dataclasses.replace(track, length=torch.as_tensor(lengths, device=track.device))


def track_to_arrays(track: TrackData) -> dict:
    """Inverse of track_from_arrays (numpy copies on the host)."""
    out = {}
    for f in dataclasses.fields(track):
        v = getattr(track, f.name)
        out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    return out


def _polyline_arrays(pos, closed, resolution, half_width, capacity, maneuver) -> dict:
    pos = _resample_polyline(np.asarray(pos, np.float64), resolution, closed)
    fwd = _forward_vectors(pos, closed)
    if maneuver is None:
        maneuver = _maneuvers_from_curvature(_curvature(pos, fwd, closed))
    n = pos.shape[0]
    capacity = n if capacity is None else capacity
    widths = np.full((n,), half_width, np.float32)
    n_slots = capacity // PROP_STRIDE
    # Pad with the last live waypoint so out-of-range gathers stay on-track.
    return {
        "pos": _pad_to(pos.astype(np.float32), capacity, pos[-1]),
        "fwd": _pad_to(fwd.astype(np.float32), capacity, fwd[-1]),
        "maneuver": _pad_to(maneuver, capacity, maneuver[-1]),
        "left_width": _pad_to(widths, capacity, half_width),
        "right_width": _pad_to(widths, capacity, half_width),
        "length": n,
        "is_loop": bool(closed),
        "prop_class": np.full((n_slots, 2), int(SegClass.NONE), np.int32),
        "prop_lateral": np.zeros((n_slots, 2), np.float32),
        "prop_height": np.zeros((n_slots, 2), np.float32),
        "prop_halfwidth": np.zeros((n_slots, 2), np.float32),
    }


def track_from_polyline(
    pos: np.ndarray,
    closed: bool,
    resolution: float = 1.0,
    half_width: float = DEFAULT_HALF_WIDTH,
    capacity: int | None = None,
    maneuver: np.ndarray | None = None,
    device="cuda",
) -> TrackData:
    """Bake a (dense) centerline polyline into a TrackData on `device`."""
    arrays = _polyline_arrays(pos, closed, resolution, half_width, capacity, maneuver)
    return track_from_arrays(arrays, device)


def _lap_points(seed, mean_radius, n_harmonics, max_extra_curvature) -> np.ndarray:
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2 * np.pi, 8192, endpoint=False)
    radius = np.full_like(theta, mean_radius)
    ks = rng.choice(np.arange(3, 9), size=n_harmonics, replace=False)
    for k in ks:
        kappa_k = max_extra_curvature / n_harmonics * rng.uniform(0.6, 1.4)
        amp = kappa_k * mean_radius**2 / (k**2 - 1)
        phase = rng.uniform(0, 2 * np.pi)
        radius += amp * np.cos(k * theta + phase)
    return np.stack([radius * np.cos(theta), radius * np.sin(theta)], axis=1)


def make_lap_track(
    seed: int = 0,
    mean_radius: float = 160.0,
    n_harmonics: int = 4,
    max_extra_curvature: float = 0.045,
    resolution: float = 1.0,
    half_width: float = DEFAULT_HALF_WIDTH,
    capacity: int | None = None,
    props: bool = False,
    device="cuda",
) -> TrackData:
    """Closed Fourier-perturbed circle; seed 0 is the canonical lap circuit.
    `props=True` dresses the roadside with the 13-class scene."""
    arrays = lap_track_arrays(seed, mean_radius, n_harmonics, max_extra_curvature, resolution,
                              half_width, capacity, props)
    return track_from_arrays(arrays, device)


def lap_track_arrays(
    seed: int = 0,
    mean_radius: float = 160.0,
    n_harmonics: int = 4,
    max_extra_curvature: float = 0.045,
    resolution: float = 1.0,
    half_width: float = DEFAULT_HALF_WIDTH,
    capacity: int | None = None,
    props: bool = False,
) -> dict:
    """make_lap_track's numpy arrays (host side, before the device copy)."""
    pts = _lap_points(seed, mean_radius, n_harmonics, max_extra_curvature)
    arrays = _polyline_arrays(pts, True, resolution, half_width, capacity, None)
    return _bake_props_arrays(arrays, seed) if props else arrays


def _smooth_noise(rng: np.random.Generator, n: int, scale: int) -> np.ndarray:
    coarse = rng.uniform(size=max(n // scale + 2, 2))
    return np.interp(np.arange(n) / scale, np.arange(coarse.size), coarse)


def _bake_props_arrays(arrays: dict, seed: int, urban_fraction: float = 0.45) -> dict:
    rng = np.random.default_rng(seed ^ 0x5EED)
    n_slots = arrays["prop_class"].shape[0]
    length = int(arrays["length"])
    live = length // PROP_STRIDE
    wp_idx = np.minimum(np.arange(n_slots) * PROP_STRIDE, length - 1)
    half_w = np.asarray(arrays["left_width"])[wp_idx]

    urban = _smooth_noise(rng, n_slots, 24) < urban_fraction
    cls = np.full((n_slots, 2), int(SegClass.NONE), np.int32)
    lat = np.zeros((n_slots, 2), np.float32)
    hgt = np.zeros((n_slots, 2), np.float32)
    hwd = np.zeros((n_slots, 2), np.float32)

    for side in range(2):
        sign = 1.0 if side == 0 else -1.0
        fence_zone = _smooth_noise(rng, n_slots, 16) < 0.5
        r = rng.uniform(size=n_slots)
        u = urban
        building = u & (r < 0.42)
        wall = u & (r >= 0.42) & (r < 0.52)
        pole = (u & (r >= 0.52) & (r < 0.60)) | (~u & (r >= 0.90) & (r < 0.95))
        sign_p = (u & (r >= 0.60) & (r < 0.65)) | (~u & (r >= 0.95) & (r < 0.97))
        ped = u & (r >= 0.65) & (r < 0.73)
        parked = u & (r >= 0.73) & (r < 0.83)
        fence = ~u & fence_zone & (r < 0.85)

        def put(mask, c, lat_lo, lat_hi, h_lo, h_hi, w_lo, w_hi):
            k = int(mask.sum())
            cls[mask, side] = int(c)
            lat[mask, side] = sign * (half_w[mask] + rng.uniform(lat_lo, lat_hi, size=k))
            hgt[mask, side] = rng.uniform(h_lo, h_hi, size=k)
            hwd[mask, side] = rng.uniform(w_lo, w_hi, size=k)

        put(building, SegClass.BUILDINGS, 5.0, 11.0, 5.0, 11.0, 2.5, 4.0)
        put(wall, SegClass.WALLS, 3.0, 4.5, 1.8, 2.6, 2.0, 2.0)
        put(pole, SegClass.POLES, 0.5, 0.8, 3.5, 5.0, 0.07, 0.10)
        put(sign_p, SegClass.TRAFFICSIGNS, 0.6, 0.9, 2.0, 2.4, 0.30, 0.40)
        put(ped, SegClass.PEDESTRIANS, 0.8, 1.6, 1.6, 1.9, 0.20, 0.28)
        put(parked, SegClass.VEHICLES, 1.1, 1.4, 1.4, 1.6, 0.9, 1.1)
        put(fence, SegClass.FENCES, 2.1, 2.4, 0.9, 1.3, 2.0, 2.0)

    cls[live:] = int(SegClass.NONE)
    return dict(arrays, prop_class=cls, prop_lateral=lat, prop_height=hgt, prop_halfwidth=hwd)


def bake_props(track: TrackData, seed: int = 0, urban_fraction: float = 0.45) -> TrackData:
    """Dress the roadside with CARLA-style scene props (host-side numpy)."""
    arrays = _bake_props_arrays(track_to_arrays(track), seed, urban_fraction)
    return track_from_arrays(arrays, track.device)


@dataclasses.dataclass
class Straight:
    length: float


@dataclasses.dataclass
class Arc:
    angle_deg: float  # positive = left turn
    radius: float


def make_segment_track(
    segments: Sequence[Straight | Arc],
    start: Iterable[float] = (0.0, 0.0),
    start_yaw: float = 0.0,
    closed: bool = False,
    resolution: float = 1.0,
    half_width: float = DEFAULT_HALF_WIDTH,
    capacity: int | None = None,
    device="cuda",
) -> TrackData:
    """Explicit straight/arc program -> TrackData (mainly for tests)."""
    pts = [np.asarray(start, np.float64)]
    yaw = float(start_yaw)
    step = resolution / 4.0
    for seg in segments:
        p = pts[-1]
        if isinstance(seg, Straight):
            n = max(int(np.ceil(seg.length / step)), 1)
            d = np.array([np.cos(yaw), np.sin(yaw)])
            for i in range(1, n + 1):
                pts.append(p + d * (seg.length * i / n))
        else:
            ang = np.deg2rad(seg.angle_deg)
            n = max(int(np.ceil(abs(ang) * seg.radius / step)), 1)
            sign = np.sign(ang) if ang != 0 else 1.0
            center = p + seg.radius * np.array(
                [np.cos(yaw + sign * np.pi / 2), np.sin(yaw + sign * np.pi / 2)]
            )
            a0 = np.arctan2(p[1] - center[1], p[0] - center[0])
            for i in range(1, n + 1):
                a = a0 + ang * i / n
                pts.append(center + seg.radius * np.array([np.cos(a), np.sin(a)]))
            yaw += ang
    return track_from_polyline(
        np.asarray(pts), closed=closed, resolution=resolution,
        half_width=half_width, capacity=capacity, device=device,
    )
