"""Profiling / tracing helpers (port of carla_ppo_tpu/utils/profiling.py).

torch.profiler trace capture (viewable in TensorBoard or Perfetto),
host-clock timing of enqueued device work, phase timers and steps/sec
counters.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

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


@contextlib.contextmanager
def device_trace(log_dir: str, device: str | torch.device = "cuda") -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block into `log_dir`
    (a `*.pt.trace.json` that TensorBoard's profile plugin and Perfetto
    read): CPU and CUDA activity on a card, CPU activity on the CPU. The
    default device raises where there is no card. On a card the block is
    the session's second step, after a warm-up step of WARM_KERNELS
    small kernels that the trace leaves out, with EDGE_S idle on each
    side. Usage:
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
        yield
        if cuda:  # the block's kernels end inside the trace
            torch.cuda.synchronize(dev)
            time.sleep(EDGE_S)
        prof.step()


class PhaseTimer:
    """Wall-clock phase accounting with steps/sec rates.

    timer.phase("rollout") context-manages a named phase; `summary()`
    reports each phase's total, calls and ms per call, and units/s where
    `units_per_call` names the phase.
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self, units_per_call: Optional[Dict[str, float]] = None) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            line = f"{name}: {total:.3f}s over {n} calls ({total / n * 1e3:.1f} ms/call)"
            if units_per_call and name in units_per_call:
                rate = units_per_call[name] * n / total
                line += f", {rate:,.0f} units/s"
            lines.append(line)
        return "\n".join(lines)


class ThroughputMeter:
    """EMA of units per second between `tick` calls (the first tick only
    starts the clock)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.rate: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, units: float) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = units / max(now - self._last, 1e-9)
            self.rate = (
                inst
                if self.rate is None
                else (1 - self.alpha) * self.rate + self.alpha * inst
            )
        self._last = now
        return self.rate or 0.0
