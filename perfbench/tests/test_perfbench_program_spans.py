"""The readers of the program's own spans (harness/program_spans.py): the
traced ranges' launches, kernel time and the card's idle time on a
synthetic trace, each new reader on synthetic readings, None wherever a
reading is missing, and a tiny CPU run in which only the host-clock
reading is made."""

import contextlib
import time

import pytest

from perfbench.harness import manifest as M
from perfbench.harness import program_spans as PS
from perfbench.harness import spans as spans_module
from perfbench.harness import trace as trace_module
from perfbench.harness.main import Run, run_cell

NEW = {"policy_sample_ms.train", "rollout_self_ms.train", "env_step_launches.train",
       "camera_prep_launches.train", "env_step_idle_ms.train", "camera_prep_idle_ms.train",
       "update_forward_ms.pixel_train", "update_backward_ms.pixel_train", "update_adam_ms.pixel_train"}


def x(name, ts, dur, cat="user_annotation", corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr):
    return x("cudaLaunchKernel", ts, 1, "cuda_runtime", corr)


def kernel(ts, dur, corr):
    return x("some_kernel", ts, dur, "kernel", corr)


def synthetic_events():
    """A block holding one rollout with two env steps and a camera prep in
    the second, a launch outside every program range and one in the
    rollout's own time; each launch makes one kernel of 10 us x its id."""
    evs = [x(trace_module.BLOCK, 0, 1000), x("carla_ppo.rollout", 100, 800),
           x("carla_ppo.env_step", 150, 100), x("carla_ppo.env_step", 400, 200),
           x("carla_ppo.camera.prep_windows", 450, 50)]
    for ts, corr in ((50, 1), (120, 2), (160, 3), (170, 4), (420, 5), (460, 6), (470, 7), (700, 8)):
        evs += [launch(ts, corr), kernel(ts + 5, 10 * corr, corr)]
    return evs


def test_program_trace_counts_launches_and_kernels_by_range():
    tr = PS.ProgramTrace()
    tr.load(synthetic_events())
    p = tr.program
    assert set(p) == {"rollout", "env_step", "camera.prep_windows"}
    assert (p["rollout"].calls, p["env_step"].calls, p["camera.prep_windows"].calls) == (1, 2, 1)
    assert p["rollout"].launches == 7  # all but the one before it
    assert p["rollout"].self_launches == 2 and p["rollout"].child_launches == 5
    assert p["rollout"].launches == p["rollout"].self_launches + p["rollout"].child_launches
    assert (p["env_step"].launches, p["env_step"].self_launches, p["env_step"].child_launches) == (5, 3, 2)
    assert p["camera.prep_windows"].launches == 2
    assert p["env_step"].device_ms == pytest.approx(10 * (3 + 4 + 5 + 6 + 7) * 1e-3)
    assert p["env_step"].self_device_ms == pytest.approx(10 * (3 + 4 + 5) * 1e-3)
    assert p["rollout"].device_ms == pytest.approx(10 * (2 + 3 + 4 + 5 + 6 + 7 + 8) * 1e-3)
    assert tr.launches[trace_module.BLOCK] == 8  # the base Trace's counts are kept
    assert tr.early == {"raw": (0, 0.0), "fitted": (0, 0.0)}
    # the card's busy union, on the host's clock (each op 5 us after its
    # launch, the least gap, taken as the clocks' offset): 50-60, 120-140,
    # 160-210, 420-540, 700-780 us
    assert p["rollout"].idle_ms == pytest.approx((800 - 20 - 50 - 120 - 80) * 1e-3)
    assert p["env_step"].idle_ms == pytest.approx((100 - 50 + 200 - 120) * 1e-3)
    assert p["camera.prep_windows"].idle_ms == 0.0  # the env step's earlier kernels still run


def host_bound_events(offset_us, drift):
    """200 env steps of 600 us, 1 ms apart, each launching 12 kernels of
    10 us (one every 50 us) onto an idle card, which starts each 5 us after
    its launch; the device's stamps run `offset_us` + `drift` x the time
    since the block began off the host's."""
    evs = [x(trace_module.BLOCK, 0, 210_000)]
    corr = 0
    for step in range(200):
        t = 1000 + 1000 * step
        evs.append(x("carla_ppo.env_step", t, 600))
        for j in range(12):
            corr += 1
            ts = t + 10 + 50 * j
            evs += [launch(ts, corr), kernel(ts + 5 + offset_us + drift * ts, 10, corr)]
    return evs


@pytest.mark.parametrize("offset_us,drift", [(0.0, 0.0), (2000.0, 0.003), (-3000.0, -0.003)])
def test_program_trace_puts_drifting_device_stamps_on_the_host_clock(offset_us, drift):
    """The card idles 600 - 12 x 10 us in each env step, whatever the offset
    and drift of the trace's device clock; raw stamps a ms off would read
    the kernels outside their ranges, or before their launches."""
    tr = PS.ProgramTrace()
    tr.load(host_bound_events(offset_us, drift))
    step = tr.program["env_step"]
    assert step.calls == 200 and step.launches == 2400
    assert step.idle_ms / step.calls == pytest.approx(0.48, abs=1e-6)
    raw_early, _ = tr.early["raw"]
    assert (raw_early > 0) == (offset_us < 0)
    assert tr.early["fitted"][1] < 1e-3  # no kernel more than 1 us before its launch
    # the offset at the first and the last launch, to one window's drift
    ends = sorted(offset_us * 1e-3 + 0.005 + drift * t for t in (1.01, 200.56))
    assert tr.offset_ms == pytest.approx(tuple(ends), abs=0.031)


def test_clock_offset_fits_the_least_gap_of_kernels_on_an_idle_card():
    """Per window, the least launch-to-start gap of the kernels that began
    on an idle card; a kernel queued behind another, or a copy (not a
    kernel launch) that waited in its call, does not set it but keeps the
    card busy; linear between windows, flat beyond; 0 with no kernel on an
    idle card."""
    dev = [(105.0, 200.0, 1), (201.0, 300.0, 2), (400.0, 450.0, 4), (452.0, 460.0, 5),
           (20_010.0, 20_020.0, 3)]
    # 2 queued behind 1, 81 us after its launch; 4 a copy; 5 started 2 us after the copy
    launches = {1: 100.0, 2: 120.0, 5: 300.0, 3: 20_000.0}
    offset = PS.clock_offset(dev, launches)
    assert offset(0.0) == offset(100.0) == 5.0
    assert offset(10_050.0) == pytest.approx(7.5)
    assert offset(30_000.0) == 10.0
    assert PS.clock_offset([(201.0, 300.0, 2)], {}) (500.0) == 0.0


class Totals:
    def __init__(self, calls, host_ms, host_self_ms=0.0):
        self.calls, self.host_ms, self.host_self_ms = calls, host_ms, host_self_ms


class Driver:
    rollout_steps = 4


def synthetic_run(spans, ranges):
    run = Run(Driver(), None, None, steps=1, window_s=1.0, chips=1)
    run.program_spans = PS.Readings(spans, ranges, 1.0)
    return run


def readers():
    cells = [M.Cell("lap_latent_seg.train"), M.Cell("pixels_joint.train")]
    found = {name: r for c in cells for name, r in c.readers().items() if name in NEW}
    assert set(found) == NEW
    return found


def test_each_new_reader_on_synthetic_readings():
    spans = {"rollout": Totals(1, 100.0, host_self_ms=20.0), "policy.sample": Totals(4, 8.0),
             "env_step": Totals(4, 20.0), "camera.prep_windows": Totals(5, 10.0),
             "camera.prep_candidates": Totals(5, 15.0), "update.loss": Totals(3, 30.0),
             "update.backward": Totals(3, 60.0), "update.adam": Totals(3, 9.0)}
    ranges = {"env_step": PS.RangeTotals(calls=4, launches=400, device_ms=2.0, idle_ms=12.0),
              "camera.prep_windows": PS.RangeTotals(calls=5, launches=100, device_ms=1.0, idle_ms=4.0),
              "camera.prep_candidates": PS.RangeTotals(calls=5, launches=150, device_ms=40.0, idle_ms=6.0),
              "update.loss": PS.RangeTotals(calls=3, launches=30, device_ms=300.0),
              "update.backward": PS.RangeTotals(calls=3, launches=60, device_ms=600.0),
              "update.adam": PS.RangeTotals(calls=3, launches=9, device_ms=90.0)}
    run = synthetic_run(spans, ranges)
    got = {name: r.read(run) for name, r in readers().items()}
    assert got == pytest.approx({
        "policy_sample_ms.train": 2.0, "rollout_self_ms.train": 5.0,
        "env_step_launches.train": 100.0, "camera_prep_launches.train": 50.0,
        "env_step_idle_ms.train": 3.0, "camera_prep_idle_ms.train": 2.0,
        "update_forward_ms.pixel_train": 100.0, "update_backward_ms.pixel_train": 200.0,
        "update_adam_ms.pixel_train": 30.0})


@pytest.mark.parametrize("missing", ["nothing read", "one range", "no trace", "no spans"])
def test_new_readers_give_none_where_a_reading_is_missing(missing):
    spans = {"rollout": Totals(1, 100.0, 20.0), "env_step": Totals(4, 20.0),
             "camera.prep_windows": Totals(5, 10.0), "camera.prep_candidates": Totals(5, 15.0),
             "policy.sample": Totals(4, 8.0)}
    ranges = {"env_step": PS.RangeTotals(calls=4, launches=400, idle_ms=1.0)}
    if missing == "nothing read":
        run = Run(Driver(), None, None, steps=1, window_s=1.0, chips=1)
        run.program_spans = None
    else:
        run = synthetic_run({} if missing == "no spans" else spans, None if missing == "no trace" else ranges)
    got = {name: r.read(run) for name, r in readers().items()}
    # the host times from the recorded iteration, the rest from the trace alone
    read = {"one range": {"policy_sample_ms.train", "rollout_self_ms.train", "env_step_launches.train",
                          "env_step_idle_ms.train"},
            "no trace": {"policy_sample_ms.train", "rollout_self_ms.train"},
            "no spans": {"env_step_launches.train", "env_step_idle_ms.train"}}.get(missing, set())
    assert {k for k, v in got.items() if v is not None} == read, got


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """Over a program that has no span recorder (the benchmark laid over an
    older checkout), the readings are None and nothing runs."""
    from carla_ppo_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")

    class NoStep:
        def step(self):
            raise AssertionError("driven without a recorder")

    run = Run(NoStep(), None, None, steps=1, window_s=1.0, chips=1)
    assert PS.readings(run) is None and run.program_spans is None


@contextlib.contextmanager
def no_trace(device):
    yield trace_module.Trace()


def test_cpu_run_reads_the_host_clock_metrics_only(monkeypatch):
    """A tiny traced run on the CPU (no device trace, no CUDA events): of the
    new metrics only the host-clock ones are read, from one more iteration
    recorded after the window."""
    monkeypatch.setattr(trace_module, "traced_block", no_trace)
    monkeypatch.setattr(spans_module, "Spans", spans_module.NoSpans)  # CUDA events
    small = {"config": {"ppo": {"num_envs": 8, "horizon": 4, "num_minibatches": 2}}}
    code, result = run_cell("lap_latent_seg.train", 3_200_000_011, 0.0, True, time.perf_counter(),
                            device="cpu", overrides=small)
    assert code == 0
    assert NEW & set(result["metrics"]) == {"policy_sample_ms.train", "rollout_self_ms.train"}
    assert result["metrics"]["rollout_self_ms.train"]["value"] > 0


def test_report_line_sets_each_program_span_beside_the_outside_span(capsys):
    """The stderr line as a card run writes it: each span's host time, the
    outside span of the same layer, each traced range's launches by child
    range, kernel time and idle time, and the kernels stamped before their
    launch, before and after the clock fit."""
    from carla_ppo_tpu_torch.utils.profiling import SpanTotals

    class Outside:
        enabled = True
        ms = {"rollout": [9.5, 10.5], "env_step": [1.0]}

    run = Run(Driver(), Outside(), None, steps=2, window_s=3.0, chips=1)
    PS._report(run, PS.Readings({"rollout": SpanTotals(1, 0.010, 0.002), "env_step": SpanTotals(2, 0.006, 0.006),
                                 "update": SpanTotals(1, 0.005, 0.001)},
                                {"rollout": PS.RangeTotals(1, 10, 8, 2, 1.0, 0.5, 7.25)}, 1.6,
                                {"raw": (3, 0.25), "fitted": (1, 0.002)}, (-0.5, 1.25)))
    line = capsys.readouterr().err
    assert line.startswith("perfbench: program spans: recorded iteration 1.6000 s, the window's mean "
                           "iteration 1.5000 s")
    assert "rollout x1: host 10.0000 ms (self 2.0000), the window's outside span 10.0000 ms;" in line
    assert "env_step x2: host 3.0000 ms (self 3.0000), the window's outside span 1.0000 ms;" in line
    assert "update x1: host 5.0000 ms (self 1.0000);" in line
    assert ("traced rollout x1: launches 10 = self 2 + children 8, kernels 1.000 ms (self 0.500), "
            "card idle 7.250 ms;") in line
    assert line.rstrip().endswith("kernels stamped before their launch, raw: 3 (by up to 0.250 ms); "
                                  "kernels stamped before their launch, fitted: 1 (by up to 0.002 ms); "
                                  "the device clock's fitted offset -0.500 to 1.250 ms")
