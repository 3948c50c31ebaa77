"""Profiling / tracing helpers (port of carla_ppo_tpu/utils/profiling.py).

torch.profiler trace capture (viewable in TensorBoard or Perfetto),
host-clock timing of enqueued device work, and the program's span
recorder.

Spans. The program's layers mark their work with `with span(name):` (the
rollout, the update and its phases, the env step, the camera's prep and
kernels, the VAE encode, the policy's sample). With no recorder active,
the default, `span` returns one shared null context: no allocation, no
clock read. Inside `with recording() as rec:` (or `device_trace`) each
span is a record in `rec.records` with its parent and its host-clock
start and end; while a torch.profiler session is on, it is also a
`record_function` range named `carla_ppo.<name>`, so that the trace shows
it beside the kernels it launched, and the device's side of each span
(its launches, its kernels' time, the card's idle time inside it) is read
from that trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, Iterator, List, Optional

import torch

from carla_ppo_tpu_torch.utils.device import resolve_device


def _tensor_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return []
    return [leaf for child in children for leaf in _tensor_leaves(child)]


def sync_fetch(out) -> None:
    """Wait for the work that produced `out` by copying its smallest tensor
    leaf (of nested dicts, lists and tuples) to the host: a
    device-to-host copy into pageable memory waits for the stream, so it
    fences everything enqueued on that stream before it. A large leaf
    costs its transfer time, so reduce to a scalar on the device before
    timing where possible. `out` without a tensor leaf (None, numbers)
    fetches nothing."""
    leaves = _tensor_leaves(out)
    if leaves:
        min(leaves, key=lambda t: t.numel()).detach().cpu()


def timeit_device(fn, *args, iters: int = 10) -> float:
    """Mean seconds per call over `iters` enqueued calls of `fn(*args)`,
    host clock (`time.perf_counter`), fenced once at the end by
    `sync_fetch` of the last call's output. The first call (kernel builds,
    cuDNN's algorithm choice, allocator warm-up) is excluded.

    The fence is the stream's order: `fn` must enqueue its work on the
    current stream and return a tensor made by the last of it, or the
    clock stops before that work ends. A fn that returns no tensor syncs
    nothing, so its time is only the host's enqueue time."""
    out = fn(*args)
    sync_fetch(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync_fetch(out)
    return (time.perf_counter() - t0) / iters


def is_kernel_launch(event: dict) -> bool:
    """Whether a torch.profiler trace event is the host's launch of a
    kernel (the runtime's or the driver's call): its kernel event, where
    the trace kept it, has the same correlation id."""
    name = event.get("name", "")
    return (event.get("cat") in ("cuda_runtime", "cuda_driver")
            and "Launch" in name and "Kernel" in name)


# On the H100 machine a torch.profiler session loses the first kernels it
# records, more the older the process, and its kernels' stamps stray from
# their launches by up to tens of ms either way, so that kernels near the
# session's edges fall outside it (scripts/profiler_drop_probe.py). device_trace
# launches WARM_KERNELS small kernels in a warm-up step to take the first
# loss, and holds the trace idle EDGE_S before and after the block, and
# between the warm-up and the trace, so that the block's kernels stay in
# and the warm-up's stay out.
WARM_KERNELS = 4096
EDGE_S = 0.05
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def device_trace(log_dir: str, device: str | torch.device = "cuda") -> Iterator["PhaseTimer"]:
    """Capture a torch.profiler trace of the enclosed block into `log_dir`
    (a `*.pt.trace.json` that TensorBoard's profile plugin and Perfetto
    read): CPU and CUDA activity on a card, CPU activity on the CPU. The
    default device raises where there is no card. On a card the block is
    the session's second step, after a warm-up step of WARM_KERNELS
    small kernels that the trace leaves out, with EDGE_S idle on each
    side. The block runs under `recording()`, so the trace shows the
    program's layers as `carla_ppo.<name>` ranges; the recorder is yielded.
    Usage:
        with device_trace("models/m/profile"):
            train_iteration(...)
    """
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        if cuda:
            warm = torch.zeros(1, device=dev)
            for _ in range(WARM_KERNELS):
                warm.add_(1.0)
            torch.cuda.synchronize(dev)
            time.sleep(EDGE_S)
        prof.step()
        if cuda:
            time.sleep(EDGE_S)
        with recording() as rec:
            yield rec
        if cuda:  # the block's kernels end inside the trace
            torch.cuda.synchronize(dev)
            time.sleep(EDGE_S)
        prof.step()


SPAN_PREFIX = "carla_ppo."


@dataclasses.dataclass
class SpanRecord:
    """One span: its name, the index of the span it ran inside (-1 at the
    top) and its host-clock start and end (time.perf_counter seconds;
    NaN until it ends)."""

    name: str
    parent: int
    start_s: float = math.nan
    end_s: float = math.nan

    @property
    def host_ms(self) -> float:
        return (self.end_s - self.start_s) * 1e3


@dataclasses.dataclass
class SpanTotals:
    """A span name's host-clock sums over its calls; the self time leaves
    out the spans that ran inside it."""

    calls: int = 0
    host_s: float = 0.0
    host_self_s: float = 0.0

    @property
    def host_ms(self) -> float:
        return self.host_s * 1e3

    @property
    def host_self_ms(self) -> float:
        return self.host_self_s * 1e3


class PhaseTimer:
    """Wall-clock phase accounting, and the program's span recorder.

    timer.phase("rollout") context-manages a named phase; `summary()`
    reports each phase's total, calls and ms per call, and units/s where
    `units_per_call` names the phase. Each phase is a record in `records`
    (nested phases name their parent) and, while a profiler is on, a
    `record_function` range `carla_ppo.<name>`, on the device trace's
    clock beside the kernels it launched. The device's side of a span is
    read from such a trace.
    """

    def __init__(self) -> None:
        self.records: List[SpanRecord] = []
        self._open: List[int] = []

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        rec = SpanRecord(name, self._open[-1] if self._open else -1)
        self._open.append(len(self.records))
        self.records.append(rec)
        # record_function costs ~16 us a call even with no profiler to see it
        ranged = torch._C._autograd._profiler_enabled()
        with torch.profiler.record_function(SPAN_PREFIX + name) if ranged else _NO_SPAN:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                rec.start_s, rec.end_s = t0, time.perf_counter()
                self._open.pop()

    def totals_by_name(self) -> Dict[str, SpanTotals]:
        """Each finished span name's SpanTotals, in order of first call."""
        child_s = [0.0] * len(self.records)
        for rec in self.records:
            if rec.parent >= 0 and not math.isnan(rec.end_s):
                child_s[rec.parent] += rec.end_s - rec.start_s
        out: Dict[str, SpanTotals] = {}
        for i, rec in enumerate(self.records):
            if math.isnan(rec.end_s):
                continue
            t = out.setdefault(rec.name, SpanTotals())
            t.calls += 1
            t.host_s += rec.end_s - rec.start_s
            t.host_self_s += rec.end_s - rec.start_s - child_s[i]
        return out

    @property
    def totals(self) -> Dict[str, float]:
        """Host seconds by phase name."""
        return {name: t.host_s for name, t in self.totals_by_name().items()}

    @property
    def counts(self) -> Dict[str, int]:
        """Finished calls by phase name."""
        return {name: t.calls for name, t in self.totals_by_name().items()}

    def summary(self, units_per_call: Optional[Dict[str, float]] = None) -> str:
        lines = []
        for name, t in sorted(self.totals_by_name().items()):
            line = f"{name}: {t.host_s:.3f}s over {t.calls} calls ({t.host_s / t.calls * 1e3:.1f} ms/call)"
            if units_per_call and name in units_per_call:
                rate = units_per_call[name] * t.calls / t.host_s
                line += f", {rate:,.0f} units/s"
            lines.append(line)
        return "\n".join(lines)


# The active recorder; None (the default) turns every span off.
_recorder: Optional[PhaseTimer] = None


def span(name: str):
    """The context that marks a layer's work as the span `name`: the
    shared null context unless a recorder is active (`recording`)."""
    rec = _recorder
    return _NO_SPAN if rec is None else rec.phase(name)


@contextlib.contextmanager
def recording() -> Iterator[PhaseTimer]:
    """Record every span of the enclosed block into the yielded
    PhaseTimer. The recorder active before is restored after the block."""
    global _recorder
    rec = PhaseTimer()
    outer, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = outer
