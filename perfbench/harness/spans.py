"""CUDA-event spans placed by the benchmark's own drivers around the calls
into each layer (the pattern of chip_smoke.py's `cuda_ms` / `timed_stages`,
commit cbdb1fb). A span is the device time between an event recorded before
the call and one recorded after it; on a host-bound path that is the host's
time to enqueue the call's work."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Sequence, Tuple

import torch


class NoSpans:
    """The untraced run's spans: nothing is recorded."""

    enabled = False

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        yield

    def flush(self) -> None:
        pass


class Spans(NoSpans):
    """Spans recorded as CUDA events, each also a `record_function` range
    `perfbench.<name>` that a device trace of the block shows."""

    enabled = True

    def __init__(self) -> None:
        self._open: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = defaultdict(list)
        self.ms: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"perfbench.{name}"):
            start.record()
            try:
                yield
            finally:
                end.record()
                self._open[name].append((start, end))

    def flush(self) -> None:
        """Read every recorded span (waits for the device)."""
        torch.cuda.synchronize()
        for name, pairs in self._open.items():
            self.ms[name].extend(s.elapsed_time(e) for s, e in pairs)
        self._open.clear()


@contextlib.contextmanager
def wrapped(targets: Sequence[Tuple[object, str, object]]) -> Iterator[None]:
    """Replace each (owner, attribute, wrapper factory) target's callable
    with factory(real) for the duration, then restore it (an attribute that
    was inherited, not the owner's own, is deleted again)."""
    saved = []
    for owner, attr, factory in targets:
        real = getattr(owner, attr)
        saved.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, factory(real))
    try:
        yield
    finally:
        for owner, attr, old in reversed(saved):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)


def timed(spans: NoSpans, name: str):
    """A wrapper factory for `wrapped`: the call inside a span `name`."""
    def factory(real):
        def call(*args, **kwargs):
            with spans.span(name):
                return real(*args, **kwargs)
        return call
    return factory


def recorded(calls: list, keep=lambda args: args):
    """A wrapper factory for `wrapped`: appends keep(arguments) of each call
    to `calls` (references, no copy) and makes the call."""
    def factory(real):
        def call(*args, **kwargs):
            calls.append(keep(args))
            return real(*args, **kwargs)
        return call
    return factory
