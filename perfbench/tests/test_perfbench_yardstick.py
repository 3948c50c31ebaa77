"""The frozen work counts against hand counts at tiny shapes."""

import pytest
import torch

from perfbench.harness import yardstick as Y

# One 80x160 seg frame through the k4 s2 VALID encoder 32/64/128/256:
# 39x79x32, 18x38x64, 8x18x128, 3x8x256 outputs, 2 x 16 x C_in x C_out each.
ENC = 2 * 16 * 1 * 32 * 39 * 79 + 2 * 16 * 32 * 64 * 18 * 38 + 2 * 16 * 64 * 128 * 8 * 18 + 2 * 16 * 128 * 256 * 3 * 8
FLAT = 3 * 8 * 256
MEAN_HEAD = 2 * FLAT * 64
# policy 67-500-300-2 and value 67-500-300-1
MLPS = 2 * (67 * 500 + 500 * 300 + 300 * 2) + 2 * (67 * 500 + 500 * 300 + 300)
# dense z -> 3x8x256, then transposed convs per input pixel: 3x8x256 -> 128 (k4),
# 8x18x128 -> 64 (k4), 18x38x64 -> 32 (k5), 39x79x32 -> 1 (k4)
DEC = (2 * 64 * FLAT + 2 * 16 * 256 * 128 * 3 * 8 + 2 * 16 * 128 * 64 * 8 * 18
       + 2 * 25 * 64 * 32 * 18 * 38 + 2 * 16 * 32 * 1 * 39 * 79)


def test_encoder_hand_count():
    assert ENC == 110_896_128


def test_pixel_iteration_flops_hand_count():
    # horizon 1, 1 env, 1 epoch: the update's forward + backward (3x) of
    # encoder, both z heads, decoder and MLPs over 1 frame, and the
    # rollout's forward of encoder, heads and MLPs over 2 frames.
    heads = 2 * MEAN_HEAD
    assert Y.pixel_iteration_flops(1, 1, 1) == 3 * (ENC + heads + DEC + MLPS) + 2 * (ENC + heads + MLPS)
    assert Y.pixel_iteration_flops(32, 1024, 3) == 3 * 3 * 32 * 1024 * (ENC + heads + DEC + MLPS) + 33 * 1024 * (ENC + heads + MLPS)


def test_latent_iteration_flops_hand_count():
    # horizon 1, 1 env, 1 epoch: two encodes (mean head only) and two MLP
    # passes in the rollout, then 3 x the MLPs over the one sample.
    assert Y.latent_iteration_flops(1, 1, 1) == 2 * (ENC + MEAN_HEAD + MLPS) + 3 * MLPS
    assert Y.latent_iteration_flops(128, 1024, 3) == 129 * 1024 * (ENC + MEAN_HEAD + MLPS) + 9 * 128 * 1024 * MLPS


def test_ground_ops_hand_count():
    # 5 pixels in one stripe of K = 3 waypoints; forward rays a = 1, 1, 2, 2, 2
    # make 2 runs: sub and mul per run and waypoint (2 x 2 x 3), then sub,
    # mul, add and min per pixel and waypoint (4 x 5 x 3), 40 per pixel.
    slab = torch.tensor([[1.0, 1.0, 2.0, 2.0, 2.0], [0.0, 1.0, 2.0, 3.0, 4.0]])
    stripes = torch.tensor([[3, 0, 5]])
    assert Y.ground_ops(2, slab, stripes) == 2 * (2 * 2 * 3 + 4 * 5 * 3 + 40 * 5)
    assert Y.ground_ops(2, slab, stripes, extra_per_env=7) == 2 * (2 * 2 * 3 + 4 * 5 * 3 + 40 * 5 + 7)


def test_composite_ops_hand_count():
    # W = 4, H = 3; candidate 0 valid at u_c = 2, half width 1 -> columns
    # 1.5 and 2.5, rows v in [0, 1] -> row 0.5: 2 covered pixels; candidate 1
    # invalid: none. Predicates: 2 candidates x (4 + 3).
    rows = torch.zeros(1, 2, 8)
    rows[0, 0, :6] = torch.tensor([2.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    rows[0, 1, :6] = torch.tensor([2.0, 5.0, 0.0, 0.0, 0.0, 3.0])
    assert Y.composite_ops(rows, 3, 4) == (2 * 7, 2)


def test_bound_takes_the_larger_of_bytes_and_operations():
    ms, by = Y.bound(3.35e9, [(33.5e9, Y.FP32_OPS_PER_S)])
    assert ms == pytest.approx(1.0) and by in ("bytes", "operations")
    ms, by = Y.bound(3.35e9, [(33.5e9 * 3, Y.FP32_OPS_PER_S), (16.75e9, Y.INT32_OPS_PER_S)])
    assert ms == pytest.approx(4.0) and by == "operations"
    ms, by = Y.bound(2 * 3.35e9, [(1.0, Y.FP32_OPS_PER_S)])
    assert ms == pytest.approx(2.0) and by == "bytes"


def test_composite_bound_counts_bytes_once():
    rows = torch.zeros(1, 8, 8)  # no valid candidate
    depth = torch.zeros(80)
    ms = Y.composite_bound_ms(rows, depth, 160)
    nbytes = 4 * (64 + 80 + 2 * 80 * 160)
    assert ms == pytest.approx(max(nbytes / Y.HBM_BYTES_PER_S, 2 * 8 * 240 / Y.FP32_OPS_PER_S) * 1e3)
