"""The program's own spans (`carla_ppo_tpu_torch.utils.profiling.span`),
read for the per-layer metrics that name a layer from inside the program.

The readers of a `--trace 1` run call `readings(run)` after the window; the
first call drives two more iterations of the cell's driver and keeps the
result on the run, so that every reader reads the same two iterations:

1. One iteration inside the program's recorder (`profiling.recording`),
   with no profiler, fenced by a synchronize: each span's host ms per
   call, with self times. The profiler would slow the host-bound
   iteration, so host times are not read from a trace.
2. One iteration traced by `trace.traced_block` (the benchmark's own
   method) inside the recorder, with the trace's `Trace` swapped for
   ProgramTrace for the duration: for each `carla_ppo.<name>` range, its
   calls, the kernel launches inside it, the device time of the kernels
   those launches made, matched by correlation id, and the time inside
   it in which the card ran nothing; and the launches and kernel time
   whose innermost range it is (self).

The benchmark's own spans are off in both (NoSpans), so that neither
iteration records anything for the window's metrics. Where a reading is
missing (a program without the recorder, no card for the trace, a span
that never ran) the reading is None, and so is the reader's value.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from . import trace
from .spans import NoSpans, wrapped

PREFIX = "carla_ppo."
# The program's spans that the benchmark's own spans also time (the
# driver's `instrument`), for the agreement line.
OUTSIDE = {"rollout": "rollout", "update": "update", "env_step": "env_step",
           "camera.prep_windows": "prep_windows", "camera.prep_candidates": "prep_candidates",
           "vae.encode": "vae_encode"}


@dataclasses.dataclass
class RangeTotals:
    """A `carla_ppo.<name>` range's sums over its calls in the trace:
    kernel launches inside it (`launches`, counted over its host interval
    as trace.Trace counts them), those inside its child ranges
    (`child_launches`) and those in none of them (`self_launches`); the
    device ms of the kernels those launches made; and `idle_ms`, the part
    of its host interval in which the card ran no kernel, copy or set
    (the gaps of the busy union trace.Trace counts for `busy_s`),
    whatever the work queued before the range."""

    calls: int = 0
    launches: int = 0
    child_launches: int = 0
    self_launches: int = 0
    device_ms: float = 0.0
    self_device_ms: float = 0.0
    idle_ms: float = 0.0


class ProgramTrace(trace.Trace):
    """trace.Trace, plus `program`: RangeTotals by span name (without the
    prefix) for the program's ranges inside the block. A launch belongs
    to every range whose host interval holds its time stamp, whatever the
    thread (the backward's launches come from autograd's thread while the
    main thread waits inside the span), and is a self launch of the
    innermost one. The ranges nest (one thread opens them all), so a
    range's launches are its self launches plus its children's exactly.

    The device's idle time inside a range is its host interval less the
    busy union inside it, with the device's stamps first put on the host's
    clock: on the H100 machine the trace's device clock can drift from the
    host's by up to 0.3% (ms across one traced iteration), so that raw
    stamps put kernels ms before their own launches. A kernel that starts
    on an idle card starts a few us after its launch; `clock_offset` fits
    the device stamps' offset from such starts (`offset_ms`, its least and
    most over the block's launches). `early` counts the kernels stamped
    before their own launch, and the most ms by which one was, as the
    trace has them and after the fit."""

    def __init__(self) -> None:
        super().__init__()
        self.program: Dict[str, RangeTotals] = {}
        self.early = {"raw": (0, 0.0), "fitted": (0, 0.0)}
        self.offset_ms = (0.0, 0.0)

    def load(self, events: List[dict]) -> None:
        super().load(events)
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
        t0, t1 = next((e["ts"], e["ts"] + e["dur"]) for e in xs
                      if e.get("cat") == "user_annotation" and e.get("name") == trace.BLOCK)
        ranges = sorted((e["ts"], -(e["ts"] + e["dur"]), e["name"][len(PREFIX):]) for e in xs
                        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)
                        and t0 <= e["ts"] <= t1)  # by start, the outer of two equal starts first
        starts = [a for a, _, _ in ranges]
        ends = [-b for _, b, _ in ranges]
        n = len(ranges)
        parent, stack = [-1] * n, []
        for i in range(n):
            while stack and ends[stack[-1]] < starts[i]:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
        kernel_ms: Dict[int, float] = defaultdict(float)
        for e in xs:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") == "kernel" and corr is not None:
                kernel_ms[corr] += e["dur"] * 1e-3
        launches = sorted((e["ts"], e.get("args", {}).get("correlation")) for e in xs
                          if trace.is_kernel_launch(e) and t0 <= e["ts"] <= t1)
        # the device ops of the block's runtime calls, chosen by correlation
        # and not by their stamps, which the device clock's drift moves
        calls = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver") and t0 <= e["ts"] <= t1
                 and e.get("args", {}).get("correlation") is not None}
        dev = sorted((e["ts"], e["ts"] + e["dur"], e["args"]["correlation"]) for e in xs
                     if e.get("cat") in trace.DEVICE_CATS and e.get("args", {}).get("correlation") in calls)
        offset = clock_offset(dev, {corr: ts for ts, corr in launches})
        on_host = on_host_clock(dev, offset)
        shifts = [offset(ts) * 1e-3 for ts, _ in launches]
        self.offset_ms = (min(shifts, default=0.0), max(shifts, default=0.0))
        for key, ops in (("raw", dev), ("fitted", on_host)):
            start = {corr: a for a, _, corr in ops}
            leads = [ts - start[corr] for ts, corr in launches if corr in start and start[corr] < ts]
            self.early[key] = (len(leads), max(leads, default=0.0) * 1e-3)
        idle_ms = _idle_ms([(a, b) for a, b, _ in on_host], t1)
        stamps = [ts for ts, _ in launches]
        own, own_ms = [0] * n, [0.0] * n
        for ts, corr in launches:
            i = bisect.bisect_right(starts, ts) - 1
            while i >= 0 and ends[i] < ts:
                i = parent[i]
            if i >= 0:
                own[i] += 1
                own_ms[i] += kernel_ms.get(corr, 0.0)
        total = [bisect.bisect_right(stamps, b) - bisect.bisect_left(stamps, a) for a, b in zip(starts, ends)]
        children, all_ms = [0] * n, list(own_ms)
        for i in range(n - 1, -1, -1):  # children start after their parents
            if parent[i] >= 0:
                children[parent[i]] += total[i]
                all_ms[parent[i]] += all_ms[i]
        for i, (_, _, name) in enumerate(ranges):
            t = self.program.setdefault(name, RangeTotals())
            t.calls += 1
            t.launches += total[i]
            t.child_launches += children[i]
            t.self_launches += own[i]
            t.device_ms += all_ms[i]
            t.self_device_ms += own_ms[i]
            t.idle_ms += idle_ms(starts[i], ends[i])


# Ops queued back to back on the card start ~1 us apart in its trace.
IDLE_GAP_US = 5.0


def clock_offset(dev: List[tuple], launch_ts: Dict[int, float], window_us: float = 10_000.0):
    """The function t -> the device stamps' offset (us) from the host's
    clock near host time t, fitted from the trace: per `window_us` of
    launches, the least gap between a kernel's launch and its start, over
    the kernels that began on an idle card (IDLE_GAP_US or more after every
    op stamped before them had ended), linear between windows and flat
    beyond them. `dev` holds the device ops (start, end, correlation) by
    start, `launch_ts` the host stamp of each kernel launch by
    correlation: a copy's call may wait for the queue before the copy
    starts, so copies only fill the card's busy time. 0 where no kernel
    began on an idle card."""
    least: Dict[int, tuple] = {}
    busy_until = float("-inf")
    for a, b, corr in dev:
        if a - busy_until >= IDLE_GAP_US and corr in launch_ts:
            t = launch_ts[corr]
            w = int(t // window_us)
            if w not in least or a - t < least[w][1]:
                least[w] = (t, a - t)
        busy_until = max(busy_until, b)
    knots = sorted(least.values())
    if not knots:
        return lambda t: 0.0
    ts = [t for t, _ in knots]
    ds = [d for _, d in knots]

    def offset(t: float) -> float:
        k = bisect.bisect_right(ts, t)
        if k == 0 or k == len(ts):
            return ds[min(k, len(ts) - 1)]
        return ds[k - 1] + (ds[k] - ds[k - 1]) * (t - ts[k - 1]) / (ts[k] - ts[k - 1])

    return offset


def on_host_clock(dev: List[tuple], offset) -> List[tuple]:
    """The device ops (start, end, correlation) moved onto the host's clock
    by `offset` (clock_offset), taken at each op's host time."""
    out = []
    for a, b, corr in dev:
        shift = offset(a)
        for _ in range(2):  # the offset at the op's host time, not at its device stamp
            shift = offset(a - shift)
        out.append((a - shift, b - shift, corr))
    return out


def _idle_ms(dev: List[tuple], t1: float):
    """The function (a, b) -> ms of [a, b] in which the card ran nothing:
    the busy union of the device ops `dev` (start, end; on the host's
    clock, in us) as trace.Trace.load builds it for the block ending at
    t1 (extended to the last op)."""
    if dev:
        t1 = max(t1, max(b for _, b in dev))
    busy = trace._union([(a, min(b, t1)) for a, b in dev])
    begins = [a for a, _ in busy]
    before = [0.0]  # busy us before each interval
    for a, b in busy:
        before.append(before[-1] + b - a)

    def busy_until(x: float) -> float:
        k = bisect.bisect_right(begins, x)
        return before[k - 1] + min(x, busy[k - 1][1]) - begins[k - 1] if k else 0.0

    return lambda a, b: ((b - a) - (busy_until(b) - busy_until(a))) * 1e-3


@dataclasses.dataclass
class Readings:
    """What the two iterations read: `spans` (the recorder's SpanTotals by
    name, iteration 1), `ranges` (RangeTotals by name, iteration 2, None
    without a trace), the iteration's host seconds (iteration 1) and
    ProgramTrace's `early` and `offset_ms` (iteration 2)."""

    spans: Dict[str, object]
    ranges: Optional[Dict[str, RangeTotals]]
    iteration_s: float
    early: Optional[Dict[str, tuple]] = None
    offset_ms: Optional[tuple] = None

    def host_ms_per_call(self, name: str) -> Optional[float]:
        t = self.spans.get(name)
        return t.host_ms / t.calls if t and t.calls else None

    def range(self, name: str) -> Optional[RangeTotals]:
        t = self.ranges.get(name) if self.ranges is not None else None
        return t if t is not None and t.calls else None


def readings(run) -> Optional[Readings]:
    """The run's Readings, made on the first call (None where the program
    has no span recorder)."""
    if not hasattr(run, "program_spans"):
        run.program_spans = _read(run)
    return run.program_spans


def _read(run) -> Optional[Readings]:
    from carla_ppo_tpu_torch.utils import profiling

    recording = getattr(profiling, "recording", None)
    if recording is None:
        return None
    drv = run.driver
    dev = drv.ctx.device
    cuda = dev.type == "cuda"
    outer_spans, drv.ctx.spans = drv.ctx.spans, NoSpans()
    try:
        with recording() as rec:
            t = time.perf_counter()
            drv.step()
            if cuda:
                torch.cuda.synchronize(dev)
            iteration_s = time.perf_counter() - t
        out = Readings(rec.totals_by_name(), None, iteration_s)
        if cuda:
            with wrapped([(trace, "Trace", lambda real: ProgramTrace)]):
                with trace.traced_block(dev) as tr, recording():
                    drv.trace_block()
            out.ranges, out.early, out.offset_ms = tr.program, tr.early, tr.offset_ms
    finally:
        drv.ctx.spans = outer_spans
    _report(run, out)
    return out


def _report(run, r: Readings) -> None:
    """One line of standard error: the recorded iteration against the
    window's mean, each program span beside the benchmark's own span of
    the same layer, each traced range's launches, kernel time and idle
    time, and the trace's kernels stamped before their launch."""
    window = run.window_s / run.steps if run.steps else float("nan")
    parts = [f"perfbench: program spans: recorded iteration {r.iteration_s:.4f} s, the window's mean "
             f"iteration {window:.4f} s"]
    for name, t in r.spans.items():
        outside = run.span_mean_ms(OUTSIDE[name]) if name in OUTSIDE and run.spans is not None else None
        parts.append(f"{name} x{t.calls}: host {t.host_ms / t.calls:.4f} ms "
                     f"(self {t.host_self_ms / t.calls:.4f})"
                     + (f", the window's outside span {outside:.4f} ms" if outside is not None else ""))
    if r.ranges is not None:
        for name, t in r.ranges.items():
            parts.append(f"traced {name} x{t.calls}: launches {t.launches} = self {t.self_launches} "
                         f"+ children {t.child_launches}, kernels {t.device_ms:.3f} ms (self {t.self_device_ms:.3f}), "
                         f"card idle {t.idle_ms:.3f} ms")
        parts += [f"kernels stamped before their launch, {key}: {n} (by up to {ms:.3f} ms)"
                  for key, (n, ms) in (r.early or {}).items()]
        if r.offset_ms is not None:
            parts.append(f"the device clock's fitted offset {r.offset_ms[0]:.3f} to {r.offset_ms[1]:.3f} ms")
    print("; ".join(parts), file=sys.stderr, flush=True)


def host_ms(run, name: str) -> Optional[float]:
    """Mean host ms of span `name` per call (iteration 1)."""
    r = readings(run)
    return None if r is None else r.host_ms_per_call(name)


def device_ms(run, name: str) -> Optional[float]:
    """Mean device ms per call of the kernels launched inside the range
    `name` (iteration 2)."""
    r = readings(run)
    t = r.range(name) if r is not None else None
    return None if t is None else t.device_ms / t.calls


def launches_per_call(run, names, per: str) -> Optional[float]:
    """Kernel launches inside the ranges `names` (iteration 2), per call of
    the span `per`."""
    r = readings(run)
    got = [r.range(n) for n in (*names, per)] if r is not None else [None]
    if any(t is None for t in got):
        return None
    return sum(t.launches for t in got[:-1]) / got[-1].calls


def idle_ms_per_call(run, names, per: str) -> Optional[float]:
    """Per call of the span `per`: the ms inside the ranges `names` in
    which the card ran nothing (iteration 2), whatever it ran before or
    after them."""
    r = readings(run)
    got = [r.range(n) for n in (*names, per)] if r is not None else [None]
    if any(t is None for t in got):
        return None
    return sum(t.idle_ms for t in got[:-1]) / got[-1].calls
