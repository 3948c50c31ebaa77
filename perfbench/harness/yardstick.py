"""The benchmark's yardstick: the card's peaks, the least time of a kernel
call, the work its inputs need, and the model FLOPs of a step.

`bound`, `ground_ops`, `composite_ops` and `pixel_iteration_flops` are
frozen copies of the functions of the same names in chip_smoke.py (commit
cbdb1fb), taking `torch` from the import instead of an argument. They count
the work these inputs need, whatever implements it, so a later kernel cannot
move them. `latent_iteration_flops` is written the same way. Nothing here reads the program.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates: 67 TFLOP/s of float32 outside the
# tensor cores, HBM3 at 3.35 TB/s, both at the 700 W power limit.
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# One float operation per FP32 lane and cycle: the kernels are built with
# -fmad=false, so a multiply and an add are two instructions. int32 min / max
# run on the 64 INT32 lanes of an SM.
FP32_OPS_PER_S = FP32_FLOPS_PER_S / 2
INT32_OPS_PER_S = FP32_FLOPS_PER_S / 4


def bound(nbytes: float, work) -> tuple[float, str]:
    """(least ms, what bounds it) of a kernel call; `work` is
    [(operations, their rate per second), ...]."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(ops / rate for ops, rate in work) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ground_ops(batch: int, slab, stripes, extra_per_env: int = 0) -> int:
    """Float operations these inputs need: for each stripe's K waypoints,
    sub and mul (dx * dx) once per run of pixels that share the forward ray
    a (a row, on a rigid camera), then sub, mul, add and a min per pixel;
    ~40 per pixel for the fetch, Frenet and ladder tail. Counted from the
    slab, so a camera whose pixels share no ray counts 6 per evaluation."""
    a = slab[0]
    starts = torch.ones_like(a, dtype=torch.bool)
    starts[1:] = a[1:] != a[:-1]
    runs = torch.cumsum(starts.to(torch.int64), 0).tolist()
    n_run = n_dist = 0
    for K, off, P in stripes.tolist():
        # runs in [off, off + P): the stripe's first pixel always starts one
        n_run += K * (1 + runs[off + P - 1] - runs[off])
        n_dist += K * P
    return batch * (2 * n_run + 4 * n_dist + 40 * slab.shape[1] + extra_per_env)


def composite_ops(rows, H: int, W: int) -> tuple[int, int]:
    """(coverage predicates, int32 mins) that these candidate rows need: the
    column and row test of every candidate, N x (W + H) per env, and one min
    per (valid candidate, pixel it covers)."""
    dev = rows.device
    u = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    ok = (rows[..., 3] > 0.0)[..., None]
    n_cols = (ok & (torch.abs(u - rows[..., 0:1]) <= rows[..., 1:2])).sum(-1)
    n_rows = ((v >= rows[..., 4:5]) & (v <= rows[..., 5:6])).sum(-1)
    B, N, _ = rows.shape
    return B * N * (W + H), int((n_cols * n_rows).sum())


def composite_bound_ms(rows, depth_rows, W: int) -> float:
    """Least ms of one class-only composite call: rows and row depths read,
    the ground frame read and the classes written (4 B a pixel each); two
    float operations per coverage predicate, one int32 min per valid
    candidate and covered pixel."""
    B, H = rows.shape[0], depth_rows.shape[0]
    nbytes = 4 * (rows.numel() + depth_rows.numel() + 2 * B * H * W)
    preds, mins = composite_ops(rows, H, W)
    return bound(nbytes, [(2 * preds, FP32_OPS_PER_S), (mins, INT32_OPS_PER_S)])[0]


def _encoder_flops(height: int, width: int, channels: int, features) -> tuple[float, int]:
    """(FLOPs of the k4 s2 VALID conv encoder per frame, its flat output size)."""
    h, w, c, enc = height, width, channels, 0.0
    for f in features:
        h, w = (h - 4) // 2 + 1, (w - 4) // 2 + 1
        enc += 2 * 16 * c * f * h * w
        c = f
    return enc, h * w * c


def _mlp_flops(obs_dim: int, hidden, num_actions: int) -> float:
    """FLOPs of the policy trunk and head plus the value trunk and head per sample."""
    def chain(dims):
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return chain((obs_dim,) + tuple(hidden) + (num_actions,)) + chain((obs_dim,) + tuple(hidden) + (1,))


def pixel_iteration_flops(horizon: int, num_envs: int, epochs: int) -> float:
    """Float operations of one pixel-PPO iteration at the shipped widths:
    the update's forward and backward (3 x the forward) of encoder, z
    heads, decoder and MLPs over every stored frame in each epoch, and the
    rollout's forward of encoder, heads and MLPs over horizon + 1 batches.
    A k x k convolution costs 2 x k^2 x C_in x C_out per output pixel (per
    input pixel for the transposed ones). The recomputed forward of the
    update is not counted."""
    h, w, c, enc = 80, 160, 1, 0.0
    for f in (32, 64, 128, 256):
        h, w = (h - 4) // 2 + 1, (w - 4) // 2 + 1
        enc += 2 * 16 * c * f * h * w
        c = f
    flat = h * w * c  # 3 x 8 x 256
    heads = 2 * 2 * flat * 64
    mlps = 2 * (67 * 500 + 500 * 300 + 300 * 2) + 2 * (67 * 500 + 500 * 300 + 300)
    dec = 2 * 64 * flat
    for f, k in ((128, 4), (64, 4), (32, 5), (1, 4)):
        dec += 2 * k * k * c * f * h * w
        h, w, c = (h - 1) * 2 + k, (w - 1) * 2 + k, f
    assert (h, w) == (80, 160)
    frames = horizon * num_envs
    return 3 * epochs * frames * (enc + heads + dec + mlps) + (horizon + 1) * num_envs * (enc + heads + mlps)


def latent_iteration_flops(horizon: int, num_envs: int, epochs: int, z_dim: int = 64,
                           frame=(80, 160, 1), features=(32, 64, 128, 256),
                           hidden=(500, 300), num_measurements: int = 3,
                           num_actions: int = 2) -> float:
    """Float operations of one frozen-VAE latent PPO iteration: the
    rollout's encoder and mean head over horizon + 1 frame batches (the
    first observation and one per step) and the policy and value MLPs over
    horizon + 1 batches (the last is the bootstrap value), then the update's
    forward and backward (3 x the forward) of the MLPs over every stored
    sample in each epoch. The frozen VAE is not trained."""
    enc, flat = _encoder_flops(*frame, features)
    mean_head = 2 * flat * z_dim
    mlps = _mlp_flops(z_dim + num_measurements, hidden, num_actions)
    batches = (horizon + 1) * num_envs
    return batches * (enc + mean_head + mlps) + 3 * epochs * horizon * num_envs * mlps

