"""The port's pixel pipeline (carla_ppo_tpu_torch/models/pixel_policy.py,
training/pixels.py) against the JAX package's, on the same numpy-seeded
inputs and converted weights, at the shipped widths (encoder 32/64/128/256,
z 64, decoder, 500/300 policy and value MLPs) on 80x160 seg frames.

Tolerances, float32 on both sides:
- policy_value / forward with injected z noise: action mean, std and
  value within 1e-5 relative (atol 1e-6); recon logits within 1e-4
  absolute;
- pixel_loss: the loss and every metric within 1e-4 relative (atol 1e-6);
  every parameter's gradient within 1e-5 of its tensor's largest magnitude
  (the conv sums run in another order);
- the rollout of a pixel_train_iteration (horizon 4, 4 envs, the JAX
  action noise injected): frames and ground-only targets agree on at least
  99.9% of pixels (the renderer's bound against the JAX package,
  tests/test_torch_routes.py: a pixel on a class boundary may flip);
  measurements and rewards within 1e-5, actions, log-probs, values and
  the bootstrap value within 1e-4 (a flipped pixel moves them by ~1e-5);
- the update of that iteration (2 minibatches x 3 epochs, the JAX
  permutations and z noise injected): both groups' Adam counts equal, the
  metrics within 1e-4 relative, every parameter within 2 x lr of the JAX
  one; with one update applied (the KL guard stops the rest) parameters
  and both Adam states within 1e-5 relative (in norm, per tensor), frozen
  parameters equal. With six updates applied (only the encoder group
  clipped) 1e-5 does not hold, and the fault is not the port's: the
  decoder's gradients are ~1e-6, a few times Adam's eps (1e-8) off its
  normalised step, and the later minibatches' decoder gradients and
  moments of the JAX package's float32 run come out up to 1.07e-2 (norm,
  relative) from the port's, while the port in float32 stays within
  1.1e-4 of the same update computed in float64. So each tensor's update
  and moments are held to 1e-3 of the port's float64 run and 2e-2 of the
  JAX package's; the optimizer's arithmetic on identical gradients is held
  to 1e-6 (tests/test_torch_convert_ckpt.py);
- warm_start_from_vae: copied tensors equal, the 3-channel first conv's
  channel sum within 1e-6 relative;
- greedy evaluate, 2 envs x 200 steps of the converted turnkey pixel agent
  on the lap and on a 3-track lap bank: every metric within 1e-3 relative
  (atol 1e-3), as tests/test_torch_ppo.py's evaluate, except the three
  centre-deviation metrics (|lateral offset| summed over every step, so
  they follow the steering's float32 differences): stated at 1e-3 before
  the first run, measured 2.1e-3 on the lap, held to 1e-2.
"""

from __future__ import annotations

import copy
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.envs import lap_bank_env as jbank_env
from carla_ppo_tpu.envs import track as jtrack
from carla_ppo_tpu.envs.types import EnvParams
from carla_ppo_tpu.models import vae_common as jvae_common
from carla_ppo_tpu.models.pixel_policy import PixelActorCritic as JPixelActorCritic
from carla_ppo_tpu.training import pixels as jpixels
from carla_ppo_tpu.training import ppo as jppo
from carla_ppo_tpu_torch.envs import lap_bank_env as tbank_env
from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
from carla_ppo_tpu_torch.ops import rasterizer_cuda as TRC
from carla_ppo_tpu_torch.training import pixels, ppo
from carla_ppo_tpu_torch.utils import convert
from carla_ppo_tpu_torch.utils.checkpoint import Checkpointer
from carla_ppo_tpu_torch.utils.device import make_generator
from tests.test_torch_common import REPO, np_tree, port_params, port_state
from tests.test_torch_routes import MIN_AGREEMENT, port_bank

Z = 64
LR = 3e-4
UPDATE_TOL = 2e-2
PORT_F64_TOL = 1e-3


def _t(x):
    return torch.as_tensor(np.array(x))


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoints", REPO / "scripts" / "export_torch_checkpoints.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(seed=0, with_decoder=True):
    """A JAX PixelActorCritic with seeded params and the port's with the
    same weights."""
    jm = JPixelActorCritic(with_decoder=with_decoder)
    jparams = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 80, 160, 1)), jnp.zeros((1, 3)),
                      jax.random.PRNGKey(1))
    tm = PixelActorCritic(with_decoder=with_decoder)
    tm.load_state_dict(convert.pixel_actor_critic_state_dict(np_tree(jparams)), strict=False)
    return jm, jparams, tm


def _batch(n=16, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "frames": rng.integers(0, 13, size=(n, 80, 160)).astype(np.uint8),
        "target_frames": rng.integers(0, 13, size=(n, 80, 160)).astype(np.uint8),
        "measurements": rng.normal(size=(n, 3)).astype(np.float32),
        "actions": np.clip(rng.normal(0.3, 0.6, size=(n, 2)), [-1, 0], [1, 1]).astype(np.float32),
        "log_probs": rng.normal(-2.0, 0.5, size=(n,)).astype(np.float32),
        "returns": rng.normal(size=(n,)).astype(np.float32),
        "advantages": rng.normal(size=(n,)).astype(np.float32),
    }


def _close_to_max(got, want, rel, err_msg=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=err_msg)


@pytest.mark.parametrize("with_decoder", [True, False])
def test_policy_value_and_forward_match(with_decoder):
    jm, jparams, tm = _pair(with_decoder=with_decoder)
    b = _batch(n=6)
    frames = b["frames"].astype(np.float32)[..., None] / 12.0
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (6, Z)))
    jpv = jm.apply(jparams, frames, b["measurements"], method=jm.policy_value)
    jfull = jm.apply(jparams, frames, b["measurements"], key)
    with torch.no_grad():
        tpv = tm.policy_value(_t(frames), _t(b["measurements"]))
        tfull = tm(_t(frames), _t(b["measurements"]), _t(noise))
    for got, want in zip(list(tpv) + list(tfull[:3]), list(jpv) + list(jfull[:3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for k in ("z_mean", "z_logstd_sq"):
        np.testing.assert_allclose(tfull[3][k].numpy(), np.asarray(jfull[3][k]), rtol=1e-5, atol=1e-5)
    if with_decoder:
        assert tfull[3]["recon_logits"].shape == (6, 80 * 160)
        np.testing.assert_allclose(tfull[3]["recon_logits"].numpy(),
                                   np.asarray(jfull[3]["recon_logits"]), rtol=0, atol=1e-4)
    else:
        assert tfull[3]["recon_logits"] is None and jfull[3]["recon_logits"] is None
    # act: the clipped sample and its log-prob from the same noise
    a_noise = np.random.default_rng(4).normal(size=(6, 2)).astype(np.float32) * 2.0
    with torch.no_grad():
        act, logp, _ = tm.act(_t(frames), _t(b["measurements"]), noise=_t(a_noise))
    mean, std = np.asarray(jpv[0]), np.asarray(jpv[1])
    want_act = np.clip(mean + std * a_noise, [-1.0, 0.0], [1.0, 1.0])
    np.testing.assert_allclose(act.numpy(), want_act, rtol=1e-5, atol=1e-6)
    assert bool((act[:, 0] >= -1).all() and (act[:, 1] >= 0).all()) and logp.shape == (6,)


@pytest.mark.parametrize("deprop_aux", [False, True])
def test_pixel_loss_and_gradients_match(deprop_aux):
    jm, jparams, tm = _pair(seed=2)
    b = _batch()
    if not deprop_aux:
        del b["target_frames"]
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (16, Z)))
    (jloss, jmet), jgrads = jax.value_and_grad(jpixels.pixel_loss, has_aux=True)(
        jparams, jm, {k: jnp.asarray(v) for k, v in b.items()}, jppo.PPOConfig(),
        jpixels.PixelConfig(deprop_aux=deprop_aux), key)
    loss, met = pixels.pixel_loss(tm, {k: _t(v) for k, v in b.items()}, ppo.PPOConfig(),
                                  pixels.PixelConfig(deprop_aux=deprop_aux), _t(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    want = convert.pixel_actor_critic_state_dict(np_tree(jgrads))
    for name, p in tm.named_parameters():
        _close_to_max(p.grad.numpy(), want[name].numpy(), 1e-5, name)


def _norm_rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


# case: (PPOConfig fields, PixelConfig fields, freeze values run on one compile)
ITERATION_CASES = {
    "encoder_clips": (dict(), dict(policy_grad_norm=0.0, encoder_grad_norm=0.5, deprop_aux=True),
                      (None,)),
    "kl_guard_and_freeze": (dict(kl_target=2e-3), dict(), (False, True)),
}


@pytest.mark.isolated
@pytest.mark.parametrize("case", sorted(ITERATION_CASES))
def test_pixel_train_iteration_matches(case, lap_params_props):
    """One JAX pixel_train_iteration against the port's rollout and update
    on its own draws: the rollout step for step with the JAX action noise,
    then the update on the JAX trajectory with the JAX permutations and z
    noise, against the JAX iteration's parameters and Adam states."""
    config_kw, pix_kw, freezes = ITERATION_CASES[case]
    config_kw = dict(horizon=4, num_envs=4, num_minibatches=2, learning_rate=LR, **config_kw)
    jconfig, jpix = jppo.PPOConfig(**config_kw), jpixels.PixelConfig(**pix_kw)
    tconfig, tpix = ppo.PPOConfig(**config_kw), pixels.PixelConfig(**pix_kw)
    T, B, E, M = 4, 4, jconfig.num_epochs, jconfig.num_minibatches
    jm = JPixelActorCritic()
    jts = jpixels.create_pixel_train_state(jm, jconfig, jax.random.PRNGKey(0), jpix)
    envs = jppo.init_env_batch(lap_params_props, B, jax.random.PRNGKey(1))
    _, roll_key, perm_key, loss_key = jax.random.split(jts.rng, 4)
    _, traj, boot, jep = jpixels.pixel_rollout(jm, jts.params, envs, lap_params_props, roll_key,
                                               jconfig, jpix)
    jtraj = np_tree(traj)
    assert jtraj["frames"].dtype == np.uint8 and not jtraj["dones"].any()

    # The rollout: the JAX action noise injected, no env ends in 4 steps.
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 2)))
                      for k in jax.random.split(roll_key, T)])
    tp = port_params(lap_params_props)
    tm = PixelActorCritic()
    tm.load_state_dict(convert.pixel_actor_critic_state_dict(np_tree(jts.params)), strict=False)
    _, ttraj, tboot, tep = pixels.pixel_rollout(tm, port_state(envs), tp, make_generator(0, "cpu"),
                                                tconfig, tpix, noise=_t(noise))
    assert (ttraj.frames.numpy() == jtraj["frames"]).mean() >= MIN_AGREEMENT
    if jpix.deprop_aux:
        assert (ttraj.target_frames.numpy() == jtraj["target_frames"]).mean() >= MIN_AGREEMENT
        assert (jtraj["target_frames"] != jtraj["frames"]).any()  # props drawn on the input only
    else:
        assert ttraj.target_frames is None
    for k, tol in (("measurements", 1e-5), ("rewards", 1e-5), ("actions", 1e-4),
                   ("log_probs", 1e-4), ("values", 1e-4)):
        np.testing.assert_allclose(getattr(ttraj, k).numpy(), jtraj[k], rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_allclose(tboot.numpy(), np.asarray(boot), rtol=1e-4, atol=1e-4)
    assert set(tep) == set(jep)

    perms = [_t(jax.random.permutation(k, B)).long() for k in jax.random.split(perm_key, E)]
    mb_keys = jax.random.split(loss_key, E * M).reshape(E, M, -1)
    noises = [_t(jax.random.normal(mb_keys[e, m], (B // M * T, Z))) for e in range(E) for m in range(M)]
    ex = _exporter()
    start = convert.pixel_actor_critic_state_dict(np_tree(jts.params))

    def port_update(freeze, dtype=torch.float32):
        """The port's pixel_update on the JAX trajectory and draws, from the
        JAX starting weights, computed in `dtype`."""
        tm.load_state_dict(start, strict=False)
        tm.to(dtype)
        ts = pixels.create_pixel_train_state(tm, tconfig, make_generator(0, "cpu"))
        fields = {k: None if v.dtype == object else _t(v) for k, v in jtraj.items()}
        fields = {k: v.to(dtype) if v is not None and v.is_floating_point() else v
                  for k, v in fields.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pixels, "frames_input", lambda f: f.to(dtype)[..., None] / 12.0)
            met = pixels.pixel_update(
                ts, pixels.PixelTrajectory(**fields), _t(boot).to(dtype), tconfig, tpix,
                freeze=None if freeze is None else torch.tensor(freeze),
                perms=perms, noises=[n.to(dtype) for n in noises])
        tree = copy.deepcopy(ts.checkpoint_tree())
        tm.to(torch.float32)
        return met, tree

    def tensors(tree, updates=True):
        """{label: parameter update or Adam moment} of a checkpoint tree."""
        out = {}
        for name, s0 in start.items():
            if updates:
                out[name] = tree["model"][name].double().numpy() - s0.double().numpy()
        for grp in pixels.GROUPS:
            for m in ("mu", "nu"):
                for name, v in tree["opt_state"][grp][m].items():
                    out[f"{grp} {m} {name}"] = v.double().numpy()
        return out

    ran_updates = False
    for freeze in freezes:
        jfreeze = None if freeze is None else jnp.bool_(freeze)
        new_jts, _, jmet = jpixels.pixel_train_iteration(jts, envs, lap_params_props, jm, jconfig,
                                                         jpix, freeze=jfreeze)
        met, got = port_update(freeze)
        for k in met:
            np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        want = ex.pixel_agent_tree(new_jts)
        applied = {g: int(want["opt_state"][g]["count"]) for g in pixels.GROUPS}
        assert {g: int(got["opt_state"][g]["count"]) for g in pixels.GROUPS} == applied
        for name, s0 in start.items():
            g, w = got["model"][name].numpy(), want["model"][name].numpy()
            assert np.abs(g - w).max() <= 2 * LR, name
            if applied["policy"] == 0:
                np.testing.assert_array_equal(g, s0.numpy(), err_msg=name)
            elif applied["policy"] == 1:
                assert _norm_rel(g, w) <= 1e-5, name
        if applied["policy"] <= 1:
            w_all = tensors(want, False)
            for label, g in tensors(got, False).items():
                assert _norm_rel(g, w_all[label]) <= 1e-5 or not np.any(w_all[label]), label
        else:
            # several updates: the port in float32 against itself in float64,
            # then against the JAX package's float32
            w_all, r_all = tensors(want), tensors(port_update(freeze, torch.float64)[1])
            for label, g in tensors(got).items():
                assert _norm_rel(g, r_all[label]) <= PORT_F64_TOL, label
                assert _norm_rel(g, w_all[label]) <= UPDATE_TOL, label
        ran_updates |= applied["policy"] > 0
        if case == "encoder_clips":
            assert met["train_grad/encoder_norm"].item() > 0.5  # the encoder group clips
    assert ran_updates
    if case == "kl_guard_and_freeze":
        assert 0 < float(jmet["train/update_skipped"]) == 1.0  # the last run was frozen


@pytest.mark.parametrize("vae", ["from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data",
                                 "rgb_bce_cnn_zdim64_beta1_kl_tolerance0.0_data"])
def test_warm_start_from_vae_matches(vae):
    """The JAX and the port warm start from the same VAE (orbax / converted)
    on the same starting weights: every tensor agrees afterwards. The de-prop
    seg VAE (1-channel source and output) copies encoder, heads and
    decoder; the RGB VAE (3 channels in and out) sums the first conv over
    its input channels and leaves the decoder as it was."""
    jm = JPixelActorCritic()
    jts = jpixels.create_pixel_train_state(jm, jppo.PPOConfig(), jax.random.PRNGKey(0))
    _, jvars = jvae_common.load_vae(str(REPO / "vae" / "models" / vae))
    want = convert.pixel_actor_critic_state_dict(
        np_tree(jpixels.warm_start_from_vae(jts, jvars).params))
    start = convert.pixel_actor_critic_state_dict(np_tree(jts.params))
    tm = PixelActorCritic()
    tm.load_state_dict(start, strict=False)
    pixels.warm_start_from_vae(tm, vae_common.load_vae(str(REPO / "models" / "torch" / "vae_models" / vae),
                                                       device="cpu"))
    got = tm.state_dict()
    rgb = vae.startswith("rgb")
    for name, w in want.items():
        if name == "encoder.convs.0.weight" and rgb:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got[name].numpy(), w.numpy(), err_msg=name)
    moved = {n for n in want if not np.array_equal(want[n].numpy(), start[n].numpy())}
    assert any(n.startswith("encoder.") for n in moved) and "mean_head.weight" in moved
    assert any(n.startswith("decoder.") for n in moved) != rgb
    assert not any(n.startswith("policy.") for n in moved)


@pytest.fixture(scope="module")
def turnkey():
    """The shipped turnkey pixel agent: JAX params from its orbax
    checkpoint, the port's model from the converted one."""
    step, jstate = _exporter().restore_pixel_agent("models/pixel_turnkey_pretrained")
    tree = Checkpointer(REPO / "models" / "torch" / "pixel_turnkey" / "checkpoints").read_tree(step)
    tm = PixelActorCritic()
    tm.load_state_dict(tree["model"])
    return jstate.params, tm.eval()


@pytest.mark.parametrize("env_kind", ["lap", "lap_bank"])
def test_pixel_evaluate_matches(env_kind, turnkey, lap_params_props):
    jparams, tm = turnkey
    if env_kind == "lap":
        jp, tp = lap_params_props, port_params(lap_params_props)
    else:
        bank = jbank_env.make_lap_bank(n_tracks=3, capacity=2048, props=True)
        jp, tp = jbank_env.lap_bank_params(bank), tbank_env.lap_bank_params(port_bank(bank))
    want = jpixels.evaluate(jparams, jp, JPixelActorCritic(), jax.random.PRNGKey(0), num_envs=2,
                            max_steps=200, config=jppo.PPOConfig(env_kind=env_kind), chunk=50)
    before = dict(TRC.LAUNCHES)
    got = pixels.evaluate(tm, tp, make_generator(0, "cpu"), num_envs=2, max_steps=200,
                          config=ppo.PPOConfig(env_kind=env_kind), chunk=50)
    assert TRC.LAUNCHES == before  # the CPU path launches no kernel
    assert set(got) == set(want)
    assert float(want["eval/distance_traveled"]) > 10.0  # the agent drives
    for k in got:
        rtol = 1e-2 if "deviation" in k else 1e-3
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=1e-3, err_msg=k)


@pytest.fixture(scope="module")
def lap_params_props():
    return EnvParams(track=jtrack.make_lap_track(seed=0, props=True))
