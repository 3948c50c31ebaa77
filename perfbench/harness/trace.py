"""One device trace of a short block, and what the metrics read from it.

The method is a copy of carla_ppo_tpu_torch/utils/profiling.device_trace
(commit cbdb1fb), kept here so that a later change to the program cannot
change how the benchmark traces: on the card a torch.profiler session loses
its first kernels and stamps kernels up to tens of ms off their launches, so
the block runs as the session's second step, after a warm-up step of
WARM_KERNELS one-element kernels that takes the first loss, with EDGE_S idle
between the warm-up and the block and on each side of it. The block itself
is a `record_function` range named BLOCK; sub-ranges name parts of it.

The trace is written as Chrome JSON into a temporary directory under TMPDIR,
read once and deleted.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

WARM_KERNELS = 4096
EDGE_S = 0.05
BLOCK = "perfbench.block"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def is_kernel_launch(event: dict) -> bool:
    """The host's launch of a kernel (the runtime's or the driver's call)."""
    name = event.get("name", "")
    return (event.get("cat") in ("cuda_runtime", "cuda_driver")
            and "Launch" in name and "Kernel" in name)


@contextlib.contextmanager
def traced_block(device: torch.device) -> Iterator["Trace"]:
    """Trace the enclosed block on `device`; the yielded Trace is filled
    when the block exits."""
    result = Trace()
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path),
        ) as prof:
            warm = torch.zeros(1, device=device)
            for _ in range(WARM_KERNELS):
                warm.add_(1.0)
            torch.cuda.synchronize(device)
            time.sleep(EDGE_S)
            prof.step()
            time.sleep(EDGE_S)
            with torch.profiler.record_function(BLOCK):
                yield result
                torch.cuda.synchronize(device)
            time.sleep(EDGE_S)
            prof.step()
        with open(path) as f:
            result.load(json.load(f)["traceEvents"])


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """What the block's trace holds, in seconds: its window, the device's
    busy time in it, device time by kernel name, kernel launches by host
    range, and the idle gaps named by the host op that ran through them."""

    def __init__(self) -> None:
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernel_s: Dict[str, float] = {}
        self.kernel_calls: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.spans: Dict[str, int] = {}
        self.idle_by_host: Dict[str, float] = {}

    def load(self, events: List[dict]) -> None:
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
        ranges = defaultdict(list)
        for e in xs:
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("perfbench."):
                ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        if not ranges.get(BLOCK):
            raise RuntimeError("the device trace holds no block range")
        t0, t1 = ranges[BLOCK][0]
        dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
               if e.get("cat") in DEVICE_CATS and t0 <= e["ts"] <= t1]
        if dev:
            t1 = max(t1, max(b for _, b, _ in dev))
        self.window_s = (t1 - t0) * 1e-6
        busy = _union([(a, min(b, t1)) for a, b, _ in dev])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        for a, b, name in dev:
            self.kernel_s[name] = self.kernel_s.get(name, 0.0) + (b - a) * 1e-6
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        launches = sorted(e["ts"] for e in xs if is_kernel_launch(e))
        for name, spans in ranges.items():
            self.launches[name] = sum(bisect.bisect_right(launches, b) - bisect.bisect_left(launches, a)
                                      for a, b in spans)
        self.spans = {name: len(spans) for name, spans in ranges.items()}
        host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                      if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")
                      and e["ts"] < t1 and e["ts"] + e["dur"] > t0)
        edges = [t0] + [x for ab in busy for x in ab] + [t1]
        active: List[Tuple[float, float, str]] = []
        i = 0
        for a, b in zip(edges[::2], edges[1::2]):  # the gaps, in time order
            if b <= a:
                continue
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            name = min(active, key=lambda h: h[1] - h[0])[2] if active else "host outside any op"
            self.idle_by_host[name] = self.idle_by_host.get(name, 0.0) + (b - a) * 1e-6

    def device_s(self, substring: str) -> float:
        """Device seconds of the kernels whose name holds `substring`."""
        return sum(s for name, s in self.kernel_s.items() if substring in name)

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
