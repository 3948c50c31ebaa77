"""utils/profiling of the port against the JAX package's.

sync_fetch and timeit_device as tests/test_utils.py checks the JAX ones
(the warm call plus `iters` timed calls, a positive time, nested trees,
None); PhaseTimer.summary() and ThroughputMeter.tick() give the JAX
strings and rates under one patched clock; device_trace writes a
torch.profiler trace on the CPU when asked and raises by default where
there is no card; is_kernel_launch picks a card trace's kernel launches.
"""

from __future__ import annotations

import itertools
import json
import os

import pytest
import torch

from carla_ppo_tpu.utils import profiling as j_profiling
from carla_ppo_tpu_torch.utils import profiling


def test_timeit_device_and_sync_fetch():
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        return {"big": x * 2.0, "small": x.sum()}

    dt = profiling.timeit_device(f, torch.ones(64, 64), iters=3)
    assert dt > 0.0
    assert calls["n"] == 4  # 1 warm call + 3 timed

    profiling.sync_fetch({"a": torch.ones(3), "b": (torch.zeros(()), None)})
    profiling.sync_fetch(None)  # no tensor leaf: nothing to fetch
    profiling.sync_fetch({"n": 1, "s": "x"})
    leaves = profiling._tensor_leaves({"x": [torch.ones(4), (torch.ones(1), 3)], "y": torch.ones(2)})
    assert [t.numel() for t in leaves] == [4, 1, 2]


class FakeClock:
    """perf_counter stand-in: each call advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 100.0, itertools.cycle(steps)

    def __call__(self):
        self.t += next(self.steps)
        return self.t


def _with_clock(module, monkeypatch, steps, run):
    monkeypatch.setattr(module.time, "perf_counter", FakeClock(steps))
    try:
        return run(module)
    finally:
        monkeypatch.undo()


def test_phase_timer_and_throughput_meter_match_jax(monkeypatch):
    steps = (0.013, 0.25, 0.0071, 1.5, 0.032)

    def run(mod):
        timer = mod.PhaseTimer()
        for name in ("rollout", "update", "rollout", "eval"):
            with timer.phase(name):
                pass
        meter = mod.ThroughputMeter(alpha=0.2)
        rates = [meter.tick(units) for units in (1024, 2048, 512, 4096)]
        return (timer.summary(), timer.summary({"rollout": 131072, "eval": 8}), rates,
                timer.totals, timer.counts)

    want = _with_clock(j_profiling, monkeypatch, steps, run)
    got = _with_clock(profiling, monkeypatch, steps, run)
    assert got == want
    assert got[0].count("\n") == 2 and "units/s" in got[1]
    assert got[2][0] == 0.0 and got[2][1] > 0.0


def test_device_trace_on_the_cpu_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path), device="cpu"):
        torch.ones(32, 32) @ torch.ones(32, 32)
    names = [n for n in os.listdir(tmp_path) if n.endswith(".pt.trace.json")]
    assert len(names) == 1
    with open(tmp_path / names[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_device_trace_defaults_to_the_card(tmp_path):
    """Without a card the default raises before anything is traced."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        with profiling.device_trace(str(tmp_path)):
            pass
    assert os.listdir(tmp_path) == []


def test_kernel_launch_events():
    """The host's kernel launches of a card's trace (runtime or driver
    call), not its copies, syncs or CPU ops; the CPU trace holds none."""
    events = [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernelExC"},
        {"cat": "cuda_driver", "name": "cuLaunchKernel"},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync"},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize"},
        {"cat": "kernel", "name": "void conv2d_kernel<float>"},
        {"cat": "cpu_op", "name": "aten::cudnn_convolution"},
        {"ph": "M", "name": "process_name"},
    ]
    assert [profiling.is_kernel_launch(e) for e in events] == [True] * 3 + [False] * 5
