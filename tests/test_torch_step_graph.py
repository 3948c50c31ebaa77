"""The env step's CUDA graph (envs/step_graph.py) against the eager body.

On the CPU: CPU tensors run the eager body (`lap_env._autoreset`), bit for
bit, and `step_graph.CALLS` counts them `eager`; the graph key tells apart
what a capture bakes in (batch size, `obs_fn`, the generator, the params'
tensors); the cache keeps at most MAX_GRAPHS keys; the flat output layout
gives back every output, unaliased; the benchmark's reader of CALLS.

On a CUDA card (`gpu` marker, skipped without one): 64 steps at B=1024
with resets firing, on the lap and the lap-bank env, with `obs_fn` None
and "vector": the graphed `autoreset_step` equals the eager body bit for
bit in every EnvState and StepOutput field and in the generator's state
after each step, and a returned step is left unchanged by the next call.
A body whose capture fails (a host read) runs eagerly, with the eager
results and generator.

This module imports neither JAX nor the JAX package, so on a machine
without JAX the card tests run with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_step_graph.py
"""

from __future__ import annotations

import collections

import pytest
import torch

from carla_ppo_tpu_torch.envs import lap_bank_env, lap_env, step_graph, track
from carla_ppo_tpu_torch.envs.types import EnvParams
from carla_ppo_tpu_torch.utils.device import make_generator

STEPS = 64
BATCH = 1024
# Short episodes with spawn noise, so that resets fire and what they draw
# shows in the state.
ENV_KW = dict(max_episode_steps=13, spawn_pos_noise=0.4, spawn_yaw_noise=0.05)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: CUDA graphs exist only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured and replayed only there")
    return torch.device("cuda")


def _env(kind: str, batch: int, device, seed: int = 0):
    """(params, initial state) of the lap or lap-bank env."""
    g = make_generator(seed, device)
    if kind == "lap":
        params = EnvParams(track=track.make_lap_track(seed=0, device=device), **ENV_KW)
        return params, lap_env.init_env_batch(params, batch, g)
    bank = lap_bank_env.make_lap_bank(n_tracks=3, capacity=2048, device=device)
    params = lap_bank_env.lap_bank_params(bank, **ENV_KW)
    return params, lap_bank_env.init_env_batch(params, batch, g)


def _actions(batch: int, steps: int, device, seed: int = 1):
    g = make_generator(seed, device)
    a = torch.rand(steps, batch, 2, generator=g, device=device)
    a[..., 0] = 2.0 * a[..., 0] - 1.0
    return a


def _assert_same(got, want):
    g, w = step_graph.tensor_leaves(got), step_graph.tensor_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _counts():
    return dict(step_graph.CALLS)


# ---- CPU ----


@pytest.mark.parametrize("kind", ["lap", "lap_bank"])
@pytest.mark.parametrize("obs_fn", [None, "vector"])
def test_cpu_runs_the_eager_body(kind, obs_fn):
    params, s0 = _env(kind, 16, "cpu")
    actions = _actions(16, 20, "cpu")
    ga, gb = make_generator(5, "cpu"), make_generator(5, "cpu")
    before = _counts()
    sa = sb = s0
    for a in actions:
        sa, oa = lap_env.autoreset_step(sa, a, params, ga, obs_fn=obs_fn)
        sb, ob = lap_env._autoreset(sb, a, params, gb, obs_fn)
        _assert_same(sa, sb)
        _assert_same(oa, ob)
        assert (oa.obs is None) == (obs_fn is None)
    assert torch.equal(ga.get_state(), gb.get_state())
    after = _counts()
    assert after["eager"] - before["eager"] == len(actions)
    assert (after["captures"], after["replays"]) == (before["captures"], before["replays"])


def test_graph_key_tells_apart_what_a_capture_bakes_in():
    params, s8 = _env("lap", 8, "cpu")
    _, s16 = _env("lap", 16, "cpu")
    g = make_generator(0, "cpu")
    a8, a16 = torch.zeros(8, 2), torch.zeros(16, 2)
    fn = lap_env._autoreset

    def key(state=s8, action=a8, prm=params, gen=g, obs_fn="vector"):
        return step_graph.graph_key(fn, state, action, prm, gen, obs_fn)

    assert key() == key() and hash(key()) == hash(key())
    assert key(state=s16, action=a16) != key()
    assert key(obs_fn=None) != key()
    assert key(action=torch.zeros(8, 3)) != key()  # the brake column
    assert key(action=a8.to(torch.bfloat16)) != key()
    assert key(gen=make_generator(0, "cpu")) != key()
    # the same values in new tensors: the graph reads the old ones' memory
    same_values = EnvParams(track=track.make_lap_track(seed=0, device="cpu"), **ENV_KW)
    assert key(prm=same_values) != key()
    assert key(prm=EnvParams(track=params.track, **{**ENV_KW, "spawn_pos_noise": 0.3})) != key()


def test_cache_stays_within_its_bound(monkeypatch):
    cache = collections.OrderedDict()
    monkeypatch.setattr(step_graph, "_GRAPHS", cache)
    n = 3 * step_graph.MAX_GRAPHS
    for k in range(n):
        step_graph._remember(("key", k), None)
        assert len(cache) == min(k + 1, step_graph.MAX_GRAPHS)
    assert list(cache) == [("key", k) for k in range(n - step_graph.MAX_GRAPHS, n)]
    # the least recently used goes first
    oldest = ("key", n - step_graph.MAX_GRAPHS)
    cache.move_to_end(oldest)
    step_graph._remember(("key", n), None)
    assert oldest in cache and ("key", n - step_graph.MAX_GRAPHS + 1) not in cache


@pytest.mark.parametrize("obs_fn", [None, "vector"])
def test_flat_layout_gives_back_every_output(obs_fn):
    """The output layout on CPU tensors: every leaf, of every dtype, comes
    back from a copy of the flat buffer equal and in its own memory."""
    params, s0 = _env("lap_bank", 8, "cpu")
    outs = lap_env._autoreset(s0, _actions(8, 1, "cpu")[0], params, make_generator(2, "cpu"), obs_fn)
    leaves = [t for part in outs for t in step_graph.tensor_leaves(part)]
    assert {t.dtype for t in leaves} == {torch.float32, torch.int32, torch.bool}
    layout = object.__new__(step_graph._StepGraph)
    layout._layout(leaves, torch.device("cpu"))
    views = layout._split(layout.flat)
    for idx in layout.out_groups:
        torch._foreach_copy_([views[i] for i in idx], [leaves[i] for i in idx])
    copy = layout.flat.clone()
    back = layout._split(copy)
    for x, y in zip(back, leaves):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        assert x.untyped_storage().data_ptr() == copy.untyped_storage().data_ptr()
    layout.flat.zero_()
    assert all(torch.equal(x, y) for x, y in zip(back, leaves))
    it = iter(back)
    rebuilt = tuple(step_graph._rebuild(part, it) for part in outs)
    _assert_same(rebuilt[0], outs[0])
    _assert_same(rebuilt[1], outs[1])
    assert (rebuilt[1].obs is None) == (obs_fn is None)


def test_benchmark_reader_reads_the_counter(monkeypatch):
    """perfbench's `env_step_graph_share.train`: replays over every call, in %."""
    from perfbench.harness.manifest import load_module, metric_path

    reader = load_module(metric_path("env_step_graph_share.train"), "env_step_graph_share_reader")
    monkeypatch.setattr(step_graph, "CALLS", {"captures": 1, "replays": 98, "eager": 1})
    assert reader.read(None) == pytest.approx(98.0)
    monkeypatch.setattr(step_graph, "CALLS", {"captures": 0, "replays": 0, "eager": 0})
    assert reader.read(None) is None


# ---- the card ----


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lap", "lap_bank"])
@pytest.mark.parametrize("obs_fn", [None, "vector"])
def test_graphed_step_equals_eager_on_card(cuda_device, kind, obs_fn):
    params, s0 = _env(kind, BATCH, cuda_device)
    actions = _actions(BATCH, STEPS, cuda_device)
    g_graph, g_eager = make_generator(7, cuda_device), make_generator(7, cuda_device)
    before = _counts()
    sg = se = s0
    prev = None
    done = 0
    for t in range(STEPS):
        sg, og = lap_env.autoreset_step(sg, actions[t], params, g_graph, obs_fn=obs_fn)
        se, oe = lap_env._autoreset(se, actions[t], params, g_eager, obs_fn)
        _assert_same(sg, se)
        _assert_same(og, oe)
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
        if prev is not None:  # the next call left the returned step as it was
            _assert_same(prev[0], prev[2])
            _assert_same(prev[1], prev[3])
        prev = (sg, og, step_graph._rebuild(se, iter([x.clone() for x in step_graph.tensor_leaves(se)])),
                step_graph._rebuild(oe, iter([x.clone() for x in step_graph.tensor_leaves(oe)])))
        done += int(og.done.sum())
    assert done > BATCH  # resets fired, in most envs more than once
    after = _counts()
    assert after["captures"] - before["captures"] <= 1
    assert ((after["captures"] - before["captures"]) + (after["replays"] - before["replays"])) == STEPS
    assert after["eager"] == before["eager"]


@pytest.mark.gpu
def test_failed_capture_runs_eagerly_on_card(cuda_device):
    """A body that reads a tensor on the host cannot be captured: its key
    runs the eager body, the generators it registered draw on as before,
    and the graph that shares its generator is captured anew."""
    params, s0 = _env("lap", BATCH, cuda_device)
    actions = _actions(BATCH, 6, cuda_device)

    def host_read(state, action, prm, generator, obs_fn):
        out = lap_env._autoreset(state, action, prm, generator, obs_fn)
        assert float(out[1].reward.sum()) == float(out[1].reward.sum())
        return out

    ga, gb = make_generator(9, cuda_device), make_generator(9, cuda_device)
    sa = sb = s0
    before = _counts()
    for t in range(len(actions)):
        fn = host_read if t in (2, 3) else lap_env._autoreset
        if t == 2:
            with pytest.warns(UserWarning, match="capture failed"):
                sa, oa = step_graph.run(fn, sa, actions[t], params, ga, "vector")
        else:
            sa, oa = step_graph.run(fn, sa, actions[t], params, ga, "vector")
        sb, ob = lap_env._autoreset(sb, actions[t], params, gb, "vector")
        _assert_same(sa, sb)
        _assert_same(oa, ob)
        assert torch.equal(ga.get_state(), gb.get_state())
    torch.randn(4, device=cuda_device)  # the default generator draws
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {"captures": 2, "replays": 2, "eager": 2}
