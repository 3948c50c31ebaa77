"""utils/profiling of the port against the JAX package's.

sync_fetch and timeit_device as tests/test_utils.py checks the JAX ones
(the warm call plus `iters` timed calls, a positive time, nested trees,
None); PhaseTimer.summary() gives the JAX strings under one patched
clock; device_trace writes a torch.profiler trace on the CPU when asked,
with the program's spans as ranges, and raises by default where there is
no card; is_kernel_launch picks a card trace's kernel launches. The span
recorder: off by default (one shared null context, nothing recorded, no
clock read, no allocation), on inside `recording` with parents and self
times, from which the phase totals, counts and summary come.
"""

from __future__ import annotations

import itertools
import json
import os
import tracemalloc

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
    """PhaseTimer's totals and summary as the JAX one's (the port has no
    ThroughputMeter: nothing read it)."""
    steps = (0.013, 0.25, 0.0071, 1.5, 0.032)

    def run(mod):
        timer = mod.PhaseTimer()
        for name in ("rollout", "update", "rollout", "eval"):
            with timer.phase(name):
                pass
        return (timer.summary(), timer.summary({"rollout": 131072, "eval": 8}), timer.totals, timer.counts)

    want = _with_clock(j_profiling, monkeypatch, steps, run)
    got = _with_clock(profiling, monkeypatch, steps, run)
    assert got == want
    assert got[0].count("\n") == 2 and "units/s" in got[1]
    assert not hasattr(profiling, "ThroughputMeter")


def test_span_is_off_by_default(monkeypatch):
    """No recorder: every span is the one shared null context, and entering
    it reads no clock, makes no event and allocates nothing."""
    assert profiling._recorder is None
    assert profiling.span("rollout") is profiling.span("env_step")

    def boom(*args, **kwargs):
        raise AssertionError("a span read the clock or made an event while off")

    monkeypatch.setattr(profiling.time, "perf_counter", boom)
    monkeypatch.setattr(profiling.torch.cuda, "Event", boom)
    with profiling.span("warm"):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 1000):
            with profiling.span("env_step"):
                pass
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after == before


def test_recording_nests_spans_with_parents_and_self_times(monkeypatch):
    """Inside `recording` each span is a record naming its parent; self
    time leaves out the children; the recorder before is restored after.
    With no profiler on, no record_function range is made (each costs
    ~16 us)."""
    monkeypatch.setattr(profiling.time, "perf_counter", FakeClock((1.0,)))

    def no_range(name):
        raise AssertionError("a record_function range with no profiler on")

    monkeypatch.setattr(profiling.torch.profiler, "record_function", no_range)
    with profiling.recording() as rec:
        assert profiling._recorder is rec
        with profiling.span("rollout"):  # clock 101 .. 108
            for k in range(2):
                with profiling.span("env_step"):  # 102 .. 103, then 104 .. 107
                    if k == 1:
                        with profiling.span("camera.prep_windows"):  # 105 .. 106
                            pass
        with profiling.span("update"):  # 109 .. 110
            pass
    assert profiling._recorder is None
    assert [(r.name, r.parent) for r in rec.records] == [
        ("rollout", -1), ("env_step", 0), ("env_step", 0), ("camera.prep_windows", 2), ("update", -1)]
    assert [r.host_ms for r in rec.records] == pytest.approx([7000.0, 1000.0, 3000.0, 1000.0, 1000.0])
    totals = rec.totals_by_name()
    assert list(totals) == ["rollout", "env_step", "camera.prep_windows", "update"]
    assert (totals["rollout"].calls, totals["env_step"].calls) == (1, 2)
    assert totals["rollout"].host_self_ms == pytest.approx(3000.0)
    assert totals["env_step"].host_ms == pytest.approx(4000.0)
    assert totals["env_step"].host_self_ms == pytest.approx(3000.0)
    # the phase timer's totals, counts and summary come from the same records
    assert rec.counts == {"rollout": 1, "env_step": 2, "camera.prep_windows": 1, "update": 1}
    assert rec.totals == pytest.approx({"rollout": 7.0, "env_step": 4.0, "camera.prep_windows": 1.0, "update": 1.0})
    assert "env_step: 4.000s over 2 calls (2000.0 ms/call)" in rec.summary().splitlines()


def test_an_open_span_is_left_out_of_the_totals():
    """A span still open (its block has not ended) has no end time yet:
    the totals count only finished spans, and its children stay in."""
    with profiling.recording() as rec:
        with profiling.span("rollout"):
            with profiling.span("env_step"):
                pass
            totals = rec.totals_by_name()
    assert list(totals) == ["env_step"] and totals["env_step"].calls == 1
    assert rec.counts == {"rollout": 1, "env_step": 1}


def test_device_trace_shows_the_spans_as_ranges(tmp_path):
    """A CPU torch.profiler session through device_trace records the block's
    spans (the recorder is on for the block) as `carla_ppo.<name>` ranges,
    each inside its parent."""
    with profiling.device_trace(str(tmp_path), device="cpu") as rec:
        with profiling.span("update"):
            with profiling.span("update.loss"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert profiling.span("update") is profiling._NO_SPAN
    assert [r.name for r in rec.records] == ["update", "update.loss"]
    (name,) = [n for n in os.listdir(tmp_path) if n.endswith(".pt.trace.json")]
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("carla_ppo.")}
    assert set(ranges) == {"carla_ppo.update", "carla_ppo.update.loss"}
    outer, inner = ranges["carla_ppo.update"], ranges["carla_ppo.update.loss"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and inner["ts"] <= mm[0]["ts"] <= inner["ts"] + inner["dur"]


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
