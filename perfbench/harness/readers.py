"""What the per-layer metric readers (perfbench/metrics/<name>.py) share.
A reader returns None where it finds nothing to read; the harness then
leaves the metric out of the line."""

from __future__ import annotations

from typing import Callable, Optional

from . import yardstick


def summed_means_ms(run, names) -> Optional[float]:
    """The sum of each span's mean per call; a span that never ran counts 0."""
    means = [run.span_mean_ms(n) for n in names]
    if all(m is None for m in means):
        return None
    return sum(m for m in means if m is not None)


def launches_per_step(run, range_name: str, steps_per_range: int) -> Optional[float]:
    """Kernel launches the host made inside the traced block's `range_name`
    ranges, per step."""
    tr = run.trace
    if tr is None or not tr.spans.get(range_name):
        return None
    return tr.launches[range_name] / (tr.spans[range_name] * steps_per_range)


def roofline_pct(run, kernel: str, trace_name: str, bound_ms: Callable) -> Optional[float]:
    """The least time of every recorded call of `kernel` in the traced block
    (yardstick bounds of its inputs) over the device time of the kernels
    named `trace_name` there, in %. None where the kernel did not run or
    the trace did not keep one kernel event per call."""
    tr = run.trace
    calls = run.driver.kernel_calls.get(kernel, [])
    n_events = sum(n for name, n in tr.kernel_calls.items() if trace_name in name) if tr else 0
    if not calls or n_events != len(calls):
        return None
    device_ms = tr.device_s(trace_name) * 1e3
    return 100.0 * sum(bound_ms(args) for args in calls) / device_ms


def ground_pass_inputs(args):
    """What the ground-pass bound reads of a call's arguments (win_cols,
    payload, slab, stripes, sky_px, hw, consts): the window and payload
    only by their sizes."""
    win_cols, payload, slab, stripes, _sky_px, hw, _consts = args
    return tuple(win_cols.shape), payload.numel(), slab, stripes, hw


def composite_inputs(args):
    """What the composite bound reads of a call's arguments (rows,
    depth_rows, ground, W): not the ground frame."""
    rows, depth_rows, _ground, W = args
    return rows, depth_rows, W


def ground_pass_bound(kept) -> float:
    win_shape, payload_numel, slab, stripes, hw = kept
    B = win_shape[0]
    nbytes = 4 * (B * win_shape[1] * win_shape[2] + payload_numel + slab.numel() + stripes.numel() + B * hw)
    return yardstick.bound(nbytes, [(yardstick.ground_ops(B, slab, stripes), yardstick.FP32_OPS_PER_S)])[0]


def composite_bound(kept) -> float:
    rows, depth_rows, W = kept
    return yardstick.composite_bound_ms(rows, depth_rows, W)


def mfu_pct(run) -> Optional[float]:
    """FLOPs the model needs in the window's steps, over the window's seconds
    x the card's float32 peak x the cards used, in %."""
    if not run.steps or run.window_s <= 0:
        return None
    flops = run.driver.flops_per_step * run.steps
    return 100.0 * flops / (run.window_s * yardstick.FP32_FLOPS_PER_S * run.chips)


def device_idle_pct(run) -> Optional[float]:
    """The share of the window's mean step with nothing running on the card,
    in %: the device's busy time in the traced step (a device quantity)
    over the window's seconds per step. Not over the traced step's own
    length: recording the host's ops slows a host-bound step, so that
    length holds the profiler's cost."""
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or not run.steps:
        return None
    return 100.0 * (1.0 - tr.busy_s / (run.window_s / run.steps))
