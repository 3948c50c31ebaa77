"""The memory-policy cell (lap_latent_granite_h.train, drivers/ppo_sequence.py)
and the data-parallel cell (lap_latent_seg.dp4_train, drivers/ppo_latent_dp.py)
at tiny sizes on the CPU: a sound program is `correct`, each stand-in that
can show on the CPU trips its limit, and the FLOP counts hold. (TF32, both
cells' control, exists only on the card.)"""

import json
import time

import pytest

from perfbench.harness import yardstick_seq
from perfbench.harness.main import Context, run_cell
from perfbench.harness.manifest import ROOT, Cell
from perfbench.harness.spans import NoSpans

SEQ = "lap_latent_granite_h.train"
DP = "lap_latent_seg.dp4_train"
TINY = {"hidden_size": 64, "shared_intermediate_size": 96, "layer_types": ["mamba", "attention", "mamba"],
        "mamba_n_heads": 4, "mamba_d_head": 32, "mamba_d_state": 8, "num_attention_heads": 8,
        "num_key_value_heads": 2, "policy": {"memory_window": 6}}
# 16 envs; horizon 30, so that the check iteration (steps 90-119, after the
# 3 warm rollouts) holds episode ends (the first come after ~70 steps)
SEQ_OVERRIDES = {"config": {**TINY, "ppo": {"num_envs": 16, "horizon": 30, "num_minibatches": 2, "num_epochs": 2}}}
DP_OVERRIDES = {"traffic": {"ranks": 2}, "config": {"ppo": {"num_envs": 8, "horizon": 8, "num_minibatches": 2}}}


def run(cell, overrides, seconds=0.0):
    code, result = run_cell(cell, 3_100_000_007, seconds, False, time.perf_counter(), device="cpu",
                            overrides=overrides)
    assert code == 0
    return result


def stand_in(cell, overrides, kind):
    import torch

    from perfbench.harness.main import deep_update

    c = Cell(cell)
    ctx = Context(3_100_000_008, torch.device("cpu"), deep_update(c.config, overrides.get("config", {})),
                  deep_update(c.traffic, overrides.get("traffic", {})), NoSpans())
    return c.driver.stand_in_readings(ctx, kind), c.limits


def passes(checks, statistical=("sample_gap",)):
    """Every check within its limit, but the actions' spread, which at a
    few hundred samples moves by ~0.05 (it is read over 65,536 on the card)."""
    return all(c["value"] <= c["limit"] for k, c in checks.items() if k not in statistical)


def test_memory_policy_cell_is_correct():
    result = run(SEQ, SEQ_OVERRIDES)
    assert passes(result["checks"]), result["checks"]
    assert set(result["checks"]) == {"rollout_gap", "ratio_gap", "first_grad_gap", "change_gap", "sample_gap"}


@pytest.mark.parametrize("kind,catches", [("no_reset", "rollout_gap"), ("stale_memory", "ratio_gap")])
def test_memory_policy_stand_in_trips_its_limit(kind, catches):
    readings, limits = stand_in(SEQ, SEQ_OVERRIDES, kind)
    assert readings[catches] > 10 * limits[catches], readings


def test_data_parallel_cell_is_correct_over_two_gloo_ranks():
    result = run(DP, DP_OVERRIDES, seconds=1.0)
    assert passes(result["checks"]), result["checks"]
    assert result["checks"]["replica_gap"]["value"] == 0.0


def test_data_parallel_local_stand_in_trips_its_limits():
    readings, limits = stand_in(DP, DP_OVERRIDES, "local")
    assert readings["replica_gap"] > limits["replica_gap"]
    assert readings["grad_gap"] > 10 * limits["grad_gap"], readings


def test_memory_policy_flops_hold():
    """The torso's forward step is ~1.49 GFLOP an env (2 per weight of
    746.5 M, the SSM's 5 per state element, attention over 129 keys), and an
    iteration at the cell's settings ~5.0e14 (with the VAE encode)."""
    with open(f"{ROOT}/perfbench/configs/lap_latent_granite_h.json") as f:
        config = json.load(f)
    tok = yardstick_seq.torso_flops_per_token(config, 67)
    weights = 746_468_288 - 9 * (4352 * 5 + 3 * 64 + 4096 + 2 * 2048) - (4 * 2048)  # less convs, norms, A, D, dt
    assert 2 * weights < tok < 2 * weights * 1.02
    it = yardstick_seq.iteration_flops(config)
    assert 4.9e14 < it < 5.1e14
    b = yardstick_seq.ssm_step_bytes(1024, 64, 64, 128, 0, True)
    assert abs(b / 3.35e12 * 1e3 - 1.29) < 0.02  # ~1.28 ms of state traffic a layer call
