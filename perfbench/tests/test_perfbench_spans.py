"""The layer spans of a traced run cover the measured window and nothing
else: set-up's check iterations (the first of them cold) and the traced
blocks after the window are not averaged into the per-layer metrics."""

import contextlib
import time
from collections import defaultdict

import pytest

from perfbench.harness import spans as spans_module
from perfbench.harness import trace as trace_module
from perfbench.harness.main import run_cell

SMALL = {"lap_latent_seg.train": {"config": {"ppo": {"num_envs": 32, "horizon": 32, "num_minibatches": 2}}},
         "pixels_joint.train": {"config": {"ppo": {"num_envs": 8, "horizon": 4, "num_minibatches": 1}}}}


class HostSpans(spans_module.NoSpans):
    """Spans on the host's clock (the CPU has no CUDA events); each one made
    is kept in `made`."""

    enabled = True
    made = []

    def __init__(self):
        self.ms = defaultdict(list)
        HostSpans.made.append(self)

    @contextlib.contextmanager
    def span(self, name):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.ms[name].append((time.perf_counter() - t) * 1e3)


@contextlib.contextmanager
def no_trace(device):
    """A traced block that records nothing (the CPU has no device trace)."""
    yield trace_module.Trace()


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seconds", [0.0, 1.0], ids=["one-step", "one-second"])
def test_spans_count_the_window_steps_only(monkeypatch, cell, seconds):
    HostSpans.made = []
    monkeypatch.setattr(spans_module, "Spans", HostSpans)
    monkeypatch.setattr(trace_module, "traced_block", no_trace)
    code, result = run_cell(cell, 3_100_000_019, seconds, True, time.perf_counter(), device="cpu",
                            overrides=SMALL[cell])
    assert code == 0
    window = HostSpans.made[0]
    assert result["attempted"] >= 1
    assert len(window.ms["rollout"]) == result["attempted"]
    assert len(window.ms["update"]) == result["attempted"]
    name = "rollout_ms.train" if cell.startswith("lap") else "rollout_ms.pixel_train"
    mean = sum(window.ms["rollout"]) / len(window.ms["rollout"])
    assert result["metrics"][name]["value"] == pytest.approx(mean)


def test_device_idle_reads_the_window_step():
    """The idle share is the traced step's device busy time over the
    window's seconds per step, not over the traced step's own length
    (which holds the profiler's cost on a host-bound step)."""
    from perfbench.harness.main import Run
    from perfbench.harness.readers import device_idle_pct

    tr = trace_module.Trace()
    tr.busy_s, tr.window_s = 0.9, 2.5
    run = Run(None, None, tr, steps=30, window_s=45.0, chips=1)
    assert device_idle_pct(run) == pytest.approx(100.0 * (1.0 - 0.9 / 1.5))
    assert device_idle_pct(Run(None, None, trace_module.Trace(), steps=30, window_s=45.0, chips=1)) is None
