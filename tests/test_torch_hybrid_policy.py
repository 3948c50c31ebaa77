"""The hybrid memory policy (models/hybrid_policy.py) against its plain
reference (tests/torch_granite_h_reference.py) at tiny widths on the CPU,
its SSM step against the recurrence, the PPO path with memory, and (`gpu`)
the CUDA step kernel against its plain twin on the card.

JAX-free. The card's tests run with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_hybrid_policy.py
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_granite_h_reference as ref  # noqa: E402

from carla_ppo_tpu_torch.models import hybrid_policy  # noqa: E402
from carla_ppo_tpu_torch.models.hybrid_policy import HybridActorCritic, HybridSizes  # noqa: E402
from carla_ppo_tpu_torch.ops import ssm  # noqa: E402
from carla_ppo_tpu_torch.training import ppo  # noqa: E402

TINY = HybridSizes(
    hidden_size=64, intermediate_size=96, layer_types=("mamba", "attention", "mamba"), mamba_expand=2,
    mamba_n_heads=4, mamba_d_head=32, mamba_d_state=8, mamba_n_groups=1, mamba_d_conv=4,
    mamba_chunk_size=256, num_attention_heads=8, num_key_value_heads=2, attention_multiplier=0.125,
    residual_multiplier=0.22, embedding_multiplier=12.0, rms_norm_eps=1e-5, memory_window=6)
B, T, OBS = 4, 10, 7


def tiny_model(seed: int = 1) -> HybridActorCritic:
    return HybridActorCritic(OBS, TINY, generator=torch.Generator().manual_seed(seed))


def warm_memory(model, batch: int = B, steps: int = 8, seed: int = 2):
    """Memory after `steps` steps with an episode start at step 3 of env 1
    (the ring full and wrapped for the others)."""
    g = torch.Generator().manual_seed(seed)
    memory = model.initial_memory(batch)
    with torch.no_grad():
        for t in range(steps):
            model.step(torch.randn(batch, OBS, generator=g), memory, memory.first)
            memory.first = torch.zeros(batch, dtype=torch.bool)
            if t == 2:
                memory.first[1] = True
    return memory


def sequence_inputs(seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    firsts = torch.zeros(B, T, dtype=torch.bool)
    firsts[1, 4] = firsts[2, 0] = firsts[3, 7] = firsts[0, 9] = True
    return torch.randn(B, T, OBS, generator=g), firsts


def memory_dict(m: hybrid_policy.Memory) -> dict:
    return dict(ssm=m.ssm, conv=m.conv, keys=m.keys, values=m.values, length=m.length, slot=m.slot)


def params_of(model) -> dict:
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def close(a, b, tol):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_step_equals_sequence_equals_reference():
    """T steps of `step` from carried memory, one call of `sequence` from
    the same memory and the reference's loop give the same means and values
    (1e-5), with episode starts mid-sequence, at step 0 and in the memory."""
    model = tiny_model()
    memory = warm_memory(model)
    memory0 = memory.clone()
    obs, firsts = sequence_inputs()
    with torch.no_grad():
        steps = [model.step(obs[:, t], memory, firsts[:, t]) for t in range(T)]
        seq_mean, std, seq_value = model.sequence(obs, memory0, firsts)
        ref_mean, ref_std, ref_value = ref.forward(params_of(model), dataclasses.asdict(TINY), obs,
                                                   memory_dict(memory0), firsts)
    step_mean = torch.stack([s[0] for s in steps], 1)
    step_value = torch.stack([s[2] for s in steps], 1)
    for got in (step_mean, seq_mean):
        assert close(got, ref_mean, 1e-5)
    for got in (step_value, seq_value):
        assert close(got, ref_value, 1e-5)
    assert torch.equal(std, ref_std)


def test_sequence_on_rows_of_a_larger_memory():
    """`envs` picks the rows of the stored memory that the sequences continue
    (the update's minibatches): the same as running those envs' own memory,
    with the gradient (through the recomputed layers) the same too."""
    model = tiny_model()
    memory = warm_memory(model, batch=6)
    obs, firsts = sequence_inputs()
    envs = torch.tensor([5, 1, 3, 0])
    own = hybrid_policy.Memory(memory.ssm[:, envs], memory.conv[:, envs], memory.keys[:, envs],
                               memory.values[:, envs], memory.length[envs], memory.first[envs], memory.slot)
    got = model.sequence(obs, memory, firsts, envs)
    want = model.sequence(obs, own, firsts)
    assert close(got[0], want[0], 1e-6) and close(got[2], want[2], 1e-6)
    g = torch.autograd.grad(got[0].sum() + got[2].sum(), model.embed.weight)[0]
    w = torch.autograd.grad(want[0].sum() + want[2].sum(), model.embed.weight)[0]
    assert close(g, w, 1e-5)


def test_step_memory_after_matches_reference():
    """The memory that T steps leave (SSM state, conv state, ring in time
    order with its validity) is the reference's after the sequence."""
    model = tiny_model()
    memory = warm_memory(model)
    memory0 = memory.clone()
    obs, firsts = sequence_inputs()
    with torch.no_grad():
        for t in range(T):
            model.step(obs[:, t], memory, firsts[:, t])
        _, after = ref.forward(params_of(model), dataclasses.asdict(TINY), obs, memory_dict(memory0), firsts,
                               return_memory=True)
    assert close(memory.ssm, torch.stack(after["ssm"]), 1e-5)
    assert close(memory.conv, torch.stack(after["conv"]), 1e-6)
    keys, values, valid = ref.ring_in_time_order(memory.keys[0], memory.values[0], memory.length, memory.slot)
    assert torch.equal(valid, after["valid"][0])
    assert close(keys[valid], after["keys"][0][valid], 1e-6)
    assert close(values[valid], after["values"][0][valid], 1e-6)


def sequence_batch(model, memory, obs, firsts, seed: int = 4) -> dict:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        mean, std, _ = model.sequence(obs, memory, firsts)
    actions = torch.clamp(mean + std * torch.randn(mean.shape, generator=g), model.action_low, model.action_high)
    return {"obs": obs, "firsts": firsts, "actions": actions,
            "log_probs": ref.gaussian_log_prob(actions, mean, std) + 0.05 * torch.randn(B, T, generator=g),
            "advantages": torch.randn(B, T, generator=g), "returns": torch.randn(B, T, generator=g)}


def test_ppo_loss_gradients_match_reference():
    """ppo.ppo_loss on a batch of env sequences (the sequence form) and the
    reference's loop give the same loss and gradients (1e-4 of each leaf's
    largest), with no gradient into the stored memory."""
    model = tiny_model()
    memory = warm_memory(model)
    obs, firsts = sequence_inputs()
    batch = sequence_batch(model, memory, obs, firsts)
    config = ppo.PPOConfig()
    memory.ssm.requires_grad_(True)
    loss, _ = ppo.ppo_loss(model, {**batch, "memory0": memory}, config)
    loss.backward()
    assert memory.ssm.grad is None
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    P = {n: p.detach().clone().requires_grad_(True) for n, p in params_of(model).items()}
    want_loss = ref.ppo_loss(P, dataclasses.asdict(TINY), batch, memory_dict(memory),
                             dataclasses.asdict(config))
    want_loss.backward()
    assert abs(float(loss.detach()) - float(want_loss.detach())) <= 1e-5 * max(1.0, abs(want_loss.item()))
    for n, g in got.items():
        w = P[n].grad
        assert w is not None, n
        assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-6), n


def ssm_case(seed: int, b: int = 3, H: int = 4, P: int = 8, N: int = 8):
    g = torch.Generator().manual_seed(seed)
    return dict(state=torch.randn(b, H, P, N, generator=g), x=torch.randn(b, H, P, generator=g),
                dt=torch.rand(b, H, generator=g) * 0.2, A=-torch.rand(H, generator=g) * 8 - 1,
                B=torch.randn(b, N, generator=g), C=torch.randn(b, N, generator=g),
                D=torch.randn(H, generator=g), first=torch.tensor([False, True, False][:b]))


@pytest.mark.parametrize("commit", [True, False])
def test_ssm_step_plain_matches_recurrence(commit):
    """The twin's step is the published recurrence written per element
    (loops over env, head, row): the reset, the decay, the rank-1 update,
    y = S C + D x; with commit False the state is left as it was."""
    c = ssm_case(0)
    state = c["state"].clone()
    y = ssm.ssm_step_plain(state, c["x"], c["dt"], c["A"], c["B"], c["C"], c["D"], c["first"], commit)
    b, H, P, N = c["state"].shape
    want_state = torch.empty_like(c["state"])
    want_y = torch.empty(b, H, P)
    for i in range(b):
        for h in range(H):
            decay = math.exp(float(c["dt"][i, h] * c["A"][h]))
            for p in range(P):
                row = torch.zeros(N) if c["first"][i] else c["state"][i, h, p] * decay
                row = row + float(c["dt"][i, h] * c["x"][i, h, p]) * c["B"][i]
                want_state[i, h, p] = row
                want_y[i, h, p] = (row * c["C"][i]).sum() + c["D"][h] * c["x"][i, h, p]
    assert close(y, want_y, 1e-6)
    assert close(state, want_state if commit else c["state"], 1e-6)


def test_ssd_scan_matches_stepping():
    """The chunked scan over T steps equals T plain steps from the same
    state, with episode starts cutting the decay (and the state before
    step 0 dropped where step 0 starts an episode)."""
    g = torch.Generator().manual_seed(5)
    b, Tn, H, P, N = 3, 9, 4, 8, 8
    x = torch.randn(b, Tn, H, P, generator=g)
    dt = torch.rand(b, Tn, H, generator=g) * 0.3
    A = -torch.rand(H, generator=g) * 4 - 1
    Bm, Cm = torch.randn(b, Tn, N, generator=g), torch.randn(b, Tn, N, generator=g)
    D = torch.randn(H, generator=g)
    state0 = torch.randn(b, H, P, N, generator=g)
    firsts = torch.zeros(b, Tn, dtype=torch.bool)
    firsts[0, 3] = firsts[1, 0] = firsts[2, 5] = firsts[2, 6] = True
    got = ssm.ssd_scan(x, dt, A, Bm, Cm, D, state0, ssm.episode_ids(firsts))
    state = state0.clone()
    want = torch.stack([ssm.ssm_step_plain(state, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D, firsts[:, t])
                        for t in range(Tn)], 1)
    assert close(got, want, 1e-5)


def test_reset_env_acts_as_fresh():
    """An env whose step starts an episode acts from then on as an env with
    fresh memory given the same observations, whatever its memory held."""
    model = tiny_model()
    memory = warm_memory(model)
    fresh = model.initial_memory(B)
    obs, _ = sequence_inputs()
    first = torch.ones(B, dtype=torch.bool)
    with torch.no_grad():
        for t in range(T):
            a = model.step(obs[:, t], memory, first)
            b = model.step(obs[:, t], fresh, first)
            first = torch.zeros(B, dtype=torch.bool)
            assert close(a[0], b[0], 1e-6) and close(a[2], b[2], 1e-6)


def test_sequence_refuses_more_than_a_chunk():
    model = HybridActorCritic(OBS, dataclasses.replace(TINY, mamba_chunk_size=4),
                              generator=torch.Generator().manual_seed(1))
    obs, firsts = sequence_inputs()
    with pytest.raises(ValueError, match="chunk"):
        model.sequence(obs, model.initial_memory(B), firsts)


def test_preset_sizes_are_published():
    """granite-4.0-h-micro layers 0-9: 746,468,288 torso parameters (nine
    Mamba-2 layers of 76,182,976 and one attention layer of 60,821,504)
    and the published widths, counted without building the model."""
    s = hybrid_policy.PRESETS["granite-4.0-h-micro"]
    h, H = s.hidden_size, s.mamba_n_heads
    mlp = 3 * h * s.intermediate_size + 2 * h
    mamba = h * (s.d_inner + s.conv_dim + H) + s.conv_dim * (s.mamba_d_conv + 1) + 3 * H + s.d_inner \
        + s.d_inner * h + mlp
    attn = h * h * 2 + 2 * h * s.num_key_value_heads * s.head_dim + mlp
    assert (mamba, attn) == (76_182_976, 60_821_504)
    assert s.n_mamba * mamba + s.n_attention * attn == 746_468_288
    assert s.layer_types.index("attention") == 5 and (s.d_inner, s.conv_dim, s.head_dim) == (4096, 4352, 64)


def tiny_lap():
    from carla_ppo_tpu_torch.envs import track
    from carla_ppo_tpu_torch.envs.types import EnvParams

    return EnvParams(track=track.make_lap_track(seed=0, props=False, device="cpu"))


def test_train_iteration_ratio_gap_and_evaluate():
    """Two lap iterations with the memory policy on vector observations: the
    first minibatch of each iteration's first epoch reads the rollout's
    log-probs back through the sequence form (ratio within 1e-5 of 1), the
    memory carries over; then a greedy evaluate, which makes its memory
    once and carries it through every chunk."""
    from carla_ppo_tpu_torch.envs.observations import obs_dim_for

    g = torch.Generator().manual_seed(0)
    params = tiny_lap()
    config = ppo.PPOConfig(num_envs=4, horizon=10, num_epochs=2, num_minibatches=2)
    model = HybridActorCritic(obs_dim_for("vector"), TINY, generator=g)
    ts = ppo.create_train_state(model, config, g)
    envs = ppo.init_env_batch(params, 4, g)
    memory = model.initial_memory(4)
    gaps = []
    real = ppo.ppo_loss

    def watched(m, batch, cfg, ent=None):
        if len(gaps) < ts.iteration + 1:
            with torch.no_grad():
                mean, std, _ = m.sequence(batch["obs"], batch["memory0"], batch["firsts"], batch["envs"])
            ratio = torch.exp(ref.gaussian_log_prob(batch["actions"], mean, std) - batch["log_probs"])
            gaps.append(float((ratio - 1).abs().max()))
        return real(m, batch, cfg, ent)

    ppo.ppo_loss = watched
    try:
        for _ in range(2):
            ts, envs, met = ppo.train_iteration(ts, envs, params, config, memory=memory)
            assert math.isfinite(float(met["train_loss/loss"]))
    finally:
        ppo.ppo_loss = real
    assert len(gaps) == 2 and max(gaps) <= 1e-5
    assert memory.slot == 20 % TINY.memory_window and not bool(memory.ssm.eq(0).all())
    with pytest.raises(ValueError, match="memory"):
        ppo.rollout(model, envs, params, g, 2, config)
    made = []
    real_initial = model.initial_memory
    model.initial_memory = lambda *a, **k: made.append(real_initial(*a, **k)) or made[-1]
    ev = ppo.evaluate(model, params, g, num_envs=2, max_steps=6, config=config, chunk=3)
    assert all(torch.isfinite(v).all() for v in ev.values())
    assert len(made) == 1 and made[0].slot == 6 % TINY.memory_window


def test_update_refuses_flat_minibatches():
    g = torch.Generator().manual_seed(0)
    params = tiny_lap()
    from carla_ppo_tpu_torch.envs.observations import obs_dim_for

    config = ppo.PPOConfig(num_envs=4, horizon=4, num_epochs=1, num_minibatches=2, minibatch_axis="flat")
    model = HybridActorCritic(obs_dim_for("vector"), TINY, generator=g)
    ts = ppo.create_train_state(model, config, g)
    with pytest.raises(ValueError, match="whole env sequences"):
        ppo.train_iteration(ts, ppo.init_env_batch(params, 4, g), params, config, memory=model.initial_memory(4))


def test_trainer_runs_memory_policy(tmp_path, monkeypatch):
    """The Trainer with a memory-policy preset (a tiny one registered for
    the test): iterations, a greedy eval, a checkpoint and a resume, after
    which the memory starts at zero."""
    from carla_ppo_tpu_torch.training.loop import Trainer, TrainerSettings

    monkeypatch.setitem(hybrid_policy.PRESETS, "tiny-test", TINY)
    settings = TrainerSettings(model_name="m", models_root=str(tmp_path), num_iterations=2, eval_interval=1,
                               eval_envs=2, eval_max_steps=4, checkpoint_interval=2, policy="tiny-test")
    config = ppo.PPOConfig(num_envs=4, horizon=4, num_epochs=1, num_minibatches=2)
    trainer = Trainer(settings, config, device="cpu", env_params=tiny_lap())
    assert isinstance(trainer.train_state.model, HybridActorCritic)
    metrics = trainer.train()
    assert math.isfinite(metrics["train_loss/loss"]) and trainer.memory.slot == 8 % TINY.memory_window
    trainer.close()
    resumed = Trainer(settings, config, device="cpu", env_params=tiny_lap())
    assert resumed.iteration == 2 and bool(resumed.memory.ssm.eq(0).all()) and bool(resumed.memory.first.all())
    resumed.close()
    with pytest.raises(NotImplementedError):
        Trainer(dataclasses.replace(settings, policy_dtype="mixed"), config, device="cpu", env_params=tiny_lap())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64, 64, 128), (5, 3, 12, 8), (2, 4, 16, 4)])
@pytest.mark.parametrize("commit", [True, False])
def test_ssm_step_kernel_matches_twin_on_card(cuda_device, shape, commit):
    """The CUDA step against its plain twin on the card, inputs as the model
    hands them (x, B, C views of one xBC row), envs starting an episode
    among them: y and the state within float32 rounding of the sum's
    order, one launch counted; the state untouched without commit."""
    from carla_ppo_tpu_torch.ops import ssm_cuda

    b, H, P, N = shape
    g = torch.Generator(device=cuda_device).manual_seed(7)
    dev = cuda_device
    xbc = torch.randn(b, H * P + 2 * N, generator=g, device=dev)
    x, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
    x = x.view(b, H, P)
    state = torch.randn(b, H, P, N, generator=g, device=dev)
    dt = torch.rand(b, H, generator=g, device=dev) * 0.1
    A = -torch.rand(H, generator=g, device=dev) * 15 - 1
    D = torch.randn(H, generator=g, device=dev)
    first = torch.rand(b, generator=g, device=dev) < 0.3
    want_state = state.clone()
    want = ssm.ssm_step_plain(want_state, x, dt, A, Bm, Cm, D, first, commit)
    got_state = state.clone()
    before = ssm_cuda.LAUNCHES["ssm_step"]
    got = ssm.ssm_step(got_state, x, dt, A, Bm, Cm, D, first, commit)
    torch.cuda.synchronize()
    assert ssm_cuda.LAUNCHES["ssm_step"] == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got_state - want_state).abs().max()) <= 1e-6 * max(1.0, float(want_state.abs().max()))
    if not commit:
        assert torch.equal(got_state, state)


@pytest.mark.gpu
def test_ssm_step_kernel_refuses_unaligned_rows(cuda_device):
    """B and C rows that do not start on 16-byte boundaries are refused
    (the kernel reads them as float4)."""
    dev = cuda_device
    xbc = torch.randn(2, 3 * 7 + 16, device=dev)
    x, Bm, Cm = torch.split(xbc, [21, 8, 8], dim=-1)
    with pytest.raises(ValueError, match="16-byte"):
        ssm.ssm_step(torch.zeros(2, 3, 7, 8, device=dev), x.reshape(2, 3, 7), torch.rand(2, 3, device=dev),
                     -torch.ones(3, device=dev), Bm, Cm, torch.ones(3, device=dev),
                     torch.zeros(2, dtype=torch.bool, device=dev))


@pytest.mark.gpu
def test_hybrid_step_on_card_matches_cpu(cuda_device):
    """The tiny policy's steps on the card (the kernel) and on the CPU (the
    twin) from the same memory agree to 1e-5."""
    model = tiny_model()
    memory = warm_memory(model)
    obs, firsts = sequence_inputs()
    card = tiny_model().to(cuda_device)
    card_memory = dataclasses.replace(memory.clone(), **{
        k: getattr(memory, k).to(cuda_device) for k in ("ssm", "conv", "keys", "values", "length", "first")})
    with torch.no_grad():
        for t in range(T):
            want = model.step(obs[:, t], memory, firsts[:, t])
            got = card.step(obs[:, t].to(cuda_device), card_memory, firsts[:, t].to(cuda_device))
            assert close(got[0].cpu(), want[0], 1e-5) and close(got[2].cpu(), want[2], 1e-5)
