"""The env step with auto-reset, replayed as one captured CUDA graph.

`lap_env.autoreset_step` hands its body (`step`, the full-batch `reset`,
`select_envs` and the observation select) to `run`. On CUDA tensors `run`
captures that body once per key as a `torch.cuda.CUDAGraph` and replays
it: a call then costs the host a few copies and one graph launch instead
of the eager body's ~425 kernel launches. CPU tensors run the eager body.

A replay keeps the eager call's values and ownership:
- each call copies the caller's state and action into the graph's input
  buffers, one `torch._foreach_copy_` per dtype;
- the graph writes every output into one flat byte buffer, and the call
  returns views of a fresh copy of it, which the caller owns;
- the caller's generator is registered with the graph, so a replay draws
  what the eager call would have drawn and advances the generator as it
  would. The warm-up before the capture draws from a copy of the
  generator, and the capture draws nothing, so no step runs twice.

A key holds everything the capture bakes in: the body, the device, every
input's shape and dtype, `obs_fn`, the EnvParams' values and the identity
of its tensors, and the generator. At most MAX_GRAPHS keys are kept, the
least recently used dropped first. A key whose capture fails runs the
eager body from then on; the generators that capture registered get back
their states from before it.

CALLS counts the calls of `run` by how they ran (always on, like
`ops/rasterizer_cuda.LAUNCHES`): `captures` (the first call of a key,
which captures and then replays), `replays` and `eager`.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import warnings
from typing import Callable, List, Tuple

import torch
from torch import Tensor

MAX_GRAPHS = 8
CALLS = {"captures": 0, "replays": 0, "eager": 0}
# key -> _StepGraph, or None where the capture failed
_GRAPHS: "collections.OrderedDict[tuple, _StepGraph | None]" = collections.OrderedDict()


@functools.lru_cache(maxsize=None)
def _field_names(cls: type) -> Tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(cls) if f.init)


def tensor_leaves(obj, out: List[Tensor] | None = None) -> List[Tensor]:
    """The tensors of a (nested) dataclass in field order; other fields
    (a StepOutput's obs of None) are left out."""
    out = [] if out is None else out
    for name in _field_names(type(obj)):
        v = getattr(obj, name)
        if isinstance(v, Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            tensor_leaves(v, out)
    return out


def _inputs(state, action: Tensor) -> List[Tensor]:
    return tensor_leaves(state) + [action]


def _fingerprint(obj, keep: List[Tensor]):
    """A hashable form of EnvParams: its values, and its tensors by
    identity (appended to `keep`, which the graph holds so that no id is
    reused while the key lives)."""
    if isinstance(obj, Tensor):
        keep.append(obj)
        return ("tensor", id(obj))
    if dataclasses.is_dataclass(obj):
        return (type(obj),) + tuple(_fingerprint(getattr(obj, f), keep) for f in _field_names(type(obj)))
    return obj


def graph_key(fn: Callable, state, action: Tensor, params, generator: torch.Generator,
              obs_fn: str | None, keep: List[Tensor] | None = None) -> tuple:
    """What a capture of `fn` on these inputs bakes in."""
    shapes = tuple((t.shape, t.dtype) for t in _inputs(state, action))
    return (fn, action.device, shapes, obs_fn, _fingerprint(params, [] if keep is None else keep),
            generator)


def _remember(key: tuple, graph: "_StepGraph | None") -> None:
    """Keep a new key's graph, dropping the least recently used beyond MAX_GRAPHS."""
    _GRAPHS[key] = graph
    while len(_GRAPHS) > MAX_GRAPHS:
        _GRAPHS.popitem(last=False)


def run(fn: Callable, state, action: Tensor, params, generator: torch.Generator,
        obs_fn: str | None):
    """`fn(state, action, params, generator, obs_fn)`, replayed as a CUDA
    graph on CUDA tensors (see the module docstring)."""
    if action.device.type != "cuda":
        CALLS["eager"] += 1
        return fn(state, action, params, generator, obs_fn)
    keep: List[Tensor] = []
    key = graph_key(fn, state, action, params, generator, obs_fn, keep)
    if key in _GRAPHS:
        _GRAPHS.move_to_end(key)
        graph = _GRAPHS[key]
        if graph is None:
            CALLS["eager"] += 1
            return fn(state, action, params, generator, obs_fn)
        CALLS["replays"] += 1
        return graph(state, action)
    # A capture registers the device's default generator and the caller's;
    # one that fails can leave them marked as capturing, so that they
    # refuse every later draw: they get back their states from before it.
    backups = [(g, g.clone_state()) for g in (generator, torch.cuda.default_generators[action.device.index])]
    try:
        graph = _StepGraph(fn, state, action, params, generator, obs_fn, keep)
    except RuntimeError as err:
        warnings.warn(f"the env step's CUDA graph capture failed; this key runs eagerly: {err}")
        for g, backup in backups:
            g.graphsafe_set_state(backup)
        # the graphs of the caller's generator hold its old state: drop them
        for k in [k for k, g in _GRAPHS.items() if g is not None and g.generator is generator]:
            del _GRAPHS[k]
        _remember(key, None)
        CALLS["eager"] += 1
        return fn(state, action, params, generator, obs_fn)
    _remember(key, graph)
    CALLS["captures"] += 1
    return graph(state, action)


class _StepGraph:
    """One captured body: its input buffers, the flat output buffer and
    the layout that splits a copy of it back into (state, StepOutput)."""

    def __init__(self, fn, state, action, params, generator, obs_fn, keep):
        dev = action.device
        self.device = dev
        self.generator = generator
        self.keep = (params, keep)
        with torch.no_grad(), torch.cuda.device(dev):
            self.inputs = [t.detach().clone() for t in _inputs(state, action)]
            s_in = _rebuild(state, iter(self.inputs))
            a_in = self.inputs[-1]
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            spare = torch.Generator(device=dev)
            spare.set_state(generator.get_state())
            with torch.cuda.stream(stream):  # warm-up, on copies
                self.templates = fn(s_in, a_in, params, spare, obs_fn)
            outs = [t for part in self.templates for t in tensor_leaves(part)]
            self.in_groups = [(idx, [self.inputs[i] for i in idx])
                              for idx in _groups([t.dtype for t in self.inputs])]
            self._layout(outs, dev)
            views = self._split(self.flat)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(generator)
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                new = fn(s_in, a_in, params, generator, obs_fn)
                new_outs = [t for part in new for t in tensor_leaves(part)]
                for idx in self.out_groups:
                    torch._foreach_copy_([views[i] for i in idx], [new_outs[i] for i in idx])

    def _layout(self, outs: List[Tensor], dev) -> None:
        """The flat buffer: one segment per dtype and trailing shape, wider
        dtypes first, so that every segment starts aligned to its item size
        and splits into its outputs along the first dimension."""
        self.out_groups = _groups([(t.dtype, t.shape[1:]) for t in outs])
        self.out_groups.sort(key=lambda idx: -outs[idx[0]].element_size())
        self.segments, start = [], 0
        for idx in self.out_groups:
            first = outs[idx[0]]
            stop = start + sum(outs[i].numel() for i in idx) * first.element_size()
            self.segments.append((idx, start, stop, first.dtype, (-1,) + tuple(first.shape[1:]),
                                  [outs[i].shape[0] for i in idx]))
            start = stop
        self.n_out = len(outs)
        self.flat = torch.empty(start, dtype=torch.uint8, device=dev)

    def _split(self, flat: Tensor) -> List[Tensor]:
        """Views of each output in `flat`, in output order."""
        views: List[Tensor] = [None] * self.n_out  # type: ignore[list-item]
        for idx, start, stop, dtype, shape, rows in self.segments:
            for i, part in zip(idx, flat[start:stop].view(dtype).view(shape).split(rows)):
                views[i] = part
        return views

    def __call__(self, state, action: Tensor):
        srcs = _inputs(state, action)
        with torch.cuda.device(self.device):
            for idx, static in self.in_groups:
                torch._foreach_copy_(static, [srcs[i] for i in idx])
            self.graph.replay()
            it = iter(self._split(self.flat.clone()))
        return tuple(_rebuild(part, it) for part in self.templates)


def _groups(keys) -> List[List[int]]:
    """Indices grouped by key, in order of first appearance."""
    by: dict = {}
    for i, k in enumerate(keys):
        by.setdefault(k, []).append(i)
    return list(by.values())


def _rebuild(template, it):
    """`template` with its tensors replaced, in `tensor_leaves`' order, by
    `it`'s (types.map_tensors does this through dataclasses.replace, at
    several times the host cost a call)."""
    kw = {}
    for name in _field_names(type(template)):
        v = getattr(template, name)
        if isinstance(v, Tensor):
            v = next(it)
        elif dataclasses.is_dataclass(v):
            v = _rebuild(v, it)
        kw[name] = v
    return type(template)(**kw)
