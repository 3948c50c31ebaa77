#!/usr/bin/env python3
"""Whether a torch.profiler trace keeps the kernels of the block it wraps, over a process's life.

    python3 scripts/profiler_drop_probe.py

On one CUDA card, for SECONDS. Every EVERY seconds of keeping the card busy
with a small convolution (two kernels a call), it records torch.profiler
sessions of CPU and CUDA activity and reads their exported traces:
- 3 calls in a plain session (torch.profiler.profile around the block);
- 3 calls with the session held open PAD_S idle (after a synchronize)
  before and after them, so that a kernel stamped up to PAD_S off its
  launch still falls inside the session's window;
- 3 calls after a warm-up step (torch.profiler.schedule: CUPTI collects
  from the profiler's start, the trace is saved from its first step), with
  WARM_KERNELS small kernels in the warm-up;
- 3 calls through utils/profiling.device_trace, HELPER_RUNS times;
- 200 calls in a plain session.
For each it prints the kernel launches the trace holds (the host side,
which is never lost) whose kernel it holds too, the launches, the kernels
it holds of no launch in it, and the least and largest offset between a
kept kernel's start and its launch's (us); for the 200 calls also the
first and last launch, in launch order, whose kernel is missing. Needs no
JAX; raises without a card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from carla_ppo_tpu_torch.utils import profiling  # noqa: E402

SECONDS = 300.0  # losses start ~1.5 min into a process
EVERY = 25.0
PAD_S = 0.05  # kernel-launch offsets up to ~28 ms have been seen on the H100 machine
WARM_KERNELS = 16
HELPER_RUNS = 5
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def session(block, pad: float = 0.0, warm: int | None = None, helper: bool = False) -> list:
    """The events of a trace of `block()`: a plain session held open `pad`
    s on each side, or (`warm` not None) one whose saved step follows a
    warm-up step of `warm` small kernels, or (`helper`) device_trace's."""
    sync = torch.cuda.synchronize
    with tempfile.TemporaryDirectory() as d:
        handler = torch.profiler.tensorboard_trace_handler(d)
        if helper:
            with profiling.device_trace(d):
                block()
        elif warm is None:
            with torch.profiler.profile(activities=ACTIVITIES, on_trace_ready=handler):
                sync()
                time.sleep(pad)
                block()
                sync()
                time.sleep(pad)
        else:
            schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
            y = torch.zeros(1, device="cuda")
            with torch.profiler.profile(activities=ACTIVITIES, schedule=schedule,
                                        on_trace_ready=handler) as prof:
                for _ in range(warm):
                    y.add_(1.0)
                sync()
                prof.step()
                block()
                sync()
                prof.step()
        with open(os.path.join(d, os.listdir(d)[0])) as f:
            return json.load(f)["traceEvents"]


def kept(events: list, where: bool = False) -> tuple:
    """(launches with their kernel, launches, kernels of no launch, min / max
    offset us[, first / last missing launch])."""
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if profiling.is_kernel_launch(e) and "correlation" in e.get("args", {}))
    kernels = {e["args"].get("correlation"): e["ts"] for e in events if e.get("cat") == "kernel"}
    offsets = [kernels[c] - ts for ts, c in launches if c in kernels]
    row = (len(offsets), len(launches), len(kernels) - len(offsets),
           round(min(offsets, default=float("nan")), 1), round(max(offsets, default=float("nan")), 1))
    if where:
        missing = [i for i, (_, c) in enumerate(launches) if c not in kernels]
        row += (missing[0], missing[-1]) if missing else (None, None)
    return row


def main() -> None:
    conv = torch.nn.Conv2d(3, 16, 3).to("cuda")
    x = torch.randn(8, 3, 64, 64, device="cuda")

    def calls(n):
        return lambda: [conv(x) for _ in range(n)]

    t0 = time.time()
    while time.time() - t0 < SECONDS:
        t = time.time()
        while time.time() - t < EVERY:  # keep the card busy, as a long program does
            conv(x)
        torch.cuda.synchronize()
        print(f"t={time.time() - t0:6.1f}s  (kept, launches, stray kernels, min/max offset us): "
              f"3 plain {kept(session(calls(3)))}; "
              f"3 padded {PAD_S * 1e3:g} ms {kept(session(calls(3), pad=PAD_S))}; "
              f"3 after a warm-up {kept(session(calls(3), warm=0))}; "
              f"3 after a warm-up of {WARM_KERNELS} kernels {kept(session(calls(3), warm=WARM_KERNELS))}; "
              f"3 through device_trace {[kept(session(calls(3), helper=True)) for _ in range(HELPER_RUNS)]}; "
              f"200 plain (+ first / last missing) {kept(session(calls(200)), where=True)}",
              flush=True)


if __name__ == "__main__":
    main()
