"""One run of one cell: set-up, the measured window, a traced block (with
`--trace 1`), the check against the reference, and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
compared for `correct`, each beside its limit, are the last lines of
standard error and the last key of that object.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from .manifest import ROOT, Cell

CACHE = os.path.join(ROOT, "build", "perfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "carla_ppo_tpu")


def fix_environment() -> None:
    """Before torch is imported: every build and kernel cache inside the
    checkout, at fixed paths, so that only the first run of a cell in a
    checkout builds (the program's own nvcc build is already under
    build/cuda)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def deep_update(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = deep_update(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Context:
    """What a driver gets: the seed, the device, the cell's configuration
    and traffic (with any test overrides merged in), and the spans."""

    def __init__(self, seed: int, device, config: dict, traffic: dict, spans):
        self.seed = int(seed)
        self.device = device
        self.config = config
        self.traffic = traffic
        self.spans = spans

    def seed_for(self, purpose: str) -> int:
        digest = hashlib.sha256(f"{self.seed}:{purpose}".encode()).digest()
        return int.from_bytes(digest[:8], "little") & (2**63 - 1)

    def generator(self, purpose: str):
        import torch
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed_for(purpose))
        return g


class Run:
    """What the per-layer metric readers read."""

    def __init__(self, driver, spans, trace, steps: int, window_s: float, chips: int):
        self.driver = driver
        self.spans = spans
        self.trace = trace
        self.steps = steps
        self.window_s = window_s
        self.chips = chips

    def span_mean_ms(self, name: str) -> Optional[float]:
        ms = self.spans.ms.get(name) if self.spans.enabled else None
        return sum(ms) / len(ms) if ms else None


def smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def alloc_retries(dev) -> int:
    """How often the caching allocator has freed its cache and retried an
    allocation (each a synchronize and cudaFree of every cached block)."""
    import torch

    return int(torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)) if dev.type == "cuda" else 0


def rate_metric(cell) -> dict:
    """The cell's one end-to-end metric other than setup_s: the rate of its
    window."""
    rates = [m for m in cell.end_to_end if m["name"] != "setup_s"]
    if len(rates) != 1:
        raise KeyError(f"{cell.name} lists {len(rates)} end-to-end metrics besides setup_s; one is its rate")
    return rates[0]


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: Optional[str] = None, overrides: Optional[dict] = None,
             faults=None) -> tuple[int, Optional[dict]]:
    """(exit code, result object). `device` None means the card, which must
    be there; tests pass "cpu" and `overrides` (merged into the
    configuration and traffic) to drive the rest of a run at a tiny size,
    and `faults` (a context manager) to break the program underneath."""
    import torch

    cell = Cell(name)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"perfbench: {name} needs {cell.chips} CUDA card(s); torch.cuda.is_available() = "
                  f"{torch.cuda.is_available()}, device_count() = {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2, None
        device = "cuda:0"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    # The configurations state float32 with TF32 off, as the program's
    # utils/device.exact_float32 sets it.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = overrides or {}
    from . import spans as spans_module
    rate = rate_metric(cell)
    # Set-up records no spans: the layer metrics read the window's calls only.
    ctx = Context(seed, dev, deep_update(cell.config, overrides.get("config", {})),
                  deep_update(cell.traffic, overrides.get("traffic", {})), spans_module.NoSpans())
    drv = cell.driver.Driver(ctx)
    with (faults if faults is not None else contextlib.nullcontext()):
        drv.setup()
        if cuda:
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0

        spans = ctx.spans = spans_module.Spans() if trace else spans_module.NoSpans()
        retries = [alloc_retries(dev)]
        steps = failed = 0
        units = 0.0
        step_s, step_cpu_s = [], []
        instrument = drv.instrument() if trace else contextlib.nullcontext()
        with instrument:
            start = last = time.perf_counter()
            cpu_last = time.process_time()
            while True:
                failed += 0 if drv.step() else 1
                if cuda:
                    torch.cuda.synchronize(dev)
                steps += 1
                units += drv.units_per_step
                now, cpu_now = time.perf_counter(), time.process_time()
                step_s.append(now - last)
                step_cpu_s.append(cpu_now - cpu_last)
                last, cpu_last = now, cpu_now
                window_s = now - start
                if window_s >= seconds:
                    break
        retries.append(alloc_retries(dev))
        spans.flush()
        tr = None
        if trace:
            from .trace import traced_block
            ctx.spans = spans_module.Spans()  # the traced block's, not read as the window's
            with traced_block(dev) as tr, drv.instrument(), drv.kernel_inputs():
                drv.trace_block()
        peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
        metrics: Dict[str, dict] = {}
        if trace:
            run = Run(drv, spans, tr, steps, window_s, cell.chips)
            units_of = {m["name"]: m["unit"] for m in cell.per_layer}
            for mname, reader in cell.readers().items():
                value = reader.read(run)
                if value is not None:
                    metrics[mname] = {"value": float(value), "unit": units_of[mname]}
        else:
            units_of = {m["name"]: m["unit"] for m in cell.end_to_end}
            metrics[rate["name"]] = {"value": units / window_s, "unit": rate["unit"]}
            metrics["setup_s"] = {"value": setup_s, "unit": units_of["setup_s"]}
        drv.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        c0 = time.perf_counter()
        readings = drv.check()
        check_s = time.perf_counter() - c0
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in readings.items()}
    correct = bool(checks) and all(c["limit"] is not None and math.isfinite(c["value"])
                                   and c["value"] <= c["limit"] for c in checks.values())
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}, which the port's benchmark may not load", file=sys.stderr)
        return 3, None
    result = {"correct": correct, "attempted": steps, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    if cuda:
        print(f"perfbench: {smi_line()}; {name} seed {seed}: {steps} steps in {window_s:.3f} s, "
              f"setup {setup_s:.3f} s, peak {peak} bytes, check {check_s:.3f} s; step seconds min "
              f"{min(step_s):.4f} median {sorted(step_s)[len(step_s) // 2]:.4f} max {max(step_s):.4f}",
              file=sys.stderr)
        print(f"perfbench: the process's CPU seconds over the window {sum(step_cpu_s):.3f}; step CPU "
              f"seconds min {min(step_cpu_s):.4f} max {max(step_cpu_s):.4f}; allocator retries in set-up "
              f"{retries[0]}, in the window {retries[1] - retries[0]}, reserved peak "
              f"{torch.cuda.memory_stats(dev).get('reserved_bytes.all.peak')}; step seconds "
              f"{[round(x, 4) for x in step_s]}", file=sys.stderr)
        if trace:
            print(f"perfbench: traced iteration {tr.window_s:.4f} s, the device busy {tr.busy_s:.4f} s of it; "
                  f"the window's mean iteration {window_s / steps:.4f} s", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0, result


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_environment()
    code, result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    sys.stderr.flush()
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
