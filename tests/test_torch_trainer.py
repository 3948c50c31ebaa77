"""The port's Trainer (carla_ppo_tpu_torch/training/loop.py) against the
JAX package's.

Both Trainers get the same scripted eval sequences and a stubbed
train_iteration (it adds 1 to the action log-std unless frozen, counts the
iteration and reports a scripted loss), so what is compared is the loop
itself: best-checkpoint steps and best_score.json, the freeze flags, the
best_key rankings, the NaN rollback (which checkpoint it restores, the
counters) and the autosave stream. Then, on the port alone, a resume of a
real (tiny) run and `restart`, and of a pixel run (warm-started once,
both Adam groups restored); and the route Trainer's three 64-route banks
and the lap-bank Trainer's two 16-track banks against the JAX Trainer's,
field for field.
"""

from __future__ import annotations

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_ppo_tpu.training import loop as j_loop
from carla_ppo_tpu.training import ppo as j_ppo
from carla_ppo_tpu_torch.training import loop
from carla_ppo_tpu_torch.training import ppo
from tests.test_torch_common import REPO, np_tree

SMALL = dict(horizon=8, num_envs=4, num_minibatches=2)


def _eval(reward, laps=0.0, distance=0.0, finished=0.0, overtakes=0.0):
    return {"eval/reward": reward, "eval/laps_completed": laps, "eval/distance_traveled": distance,
            "eval/finished": finished, "eval/overtakes": overtakes}


def _run(trainer_cls, module, ppo_module, settings, config, evals, losses, monkeypatch):
    """Train with scripted evals and a stubbed iteration; returns what the
    loop decided at each step."""
    script = list(evals)
    freezes = []
    monkeypatch.setattr(trainer_cls, "evaluate", lambda self: dict(script.pop(0)))
    jax_side = trainer_cls is j_loop.Trainer

    def stub(ts, envs, *args, freeze=None, **kwargs):
        it = int(ts.iteration)
        frozen = freeze is not None and bool(freeze)
        freezes.append(None if freeze is None else frozen)
        step = 0.0 if frozen else 1.0
        if jax_side:
            p = ts.params["params"]
            ts = ts.replace(
                params={"params": {**p, "action_logstd": p["action_logstd"] + step}},
                iteration=ts.iteration + 1, train_step=ts.train_step + 12)
        else:
            with torch.no_grad():
                ts.model.action_logstd += step
            ts.iteration += 1
            ts.train_step += 12
        return ts, envs, {"train_loss/loss": jnp.float32(losses[it]) if jax_side
                          else torch.tensor(losses[it])}

    monkeypatch.setattr(ppo_module, "train_iteration", stub)
    kwargs = {} if jax_side else {"device": "cpu"}
    trainer = trainer_cls(settings(module), config(ppo_module), **kwargs)
    start_score = tuple(trainer.best_eval_score)
    trainer.train()
    if jax_side:
        best_steps = sorted(trainer.checkpointer._manager.all_steps())
        auto_steps = sorted(trainer.autosaver._manager.all_steps())
        logstd = np.asarray(trainer.train_state.params["params"]["action_logstd"])
    else:
        best_steps, auto_steps = trainer.checkpointer.all_steps(), trainer.autosaver.all_steps()
        logstd = trainer.train_state.model.action_logstd.detach().numpy()
    best_json = None
    if os.path.exists(os.path.join(trainer.model_dir, "best_score.json")):
        with open(os.path.join(trainer.model_dir, "best_score.json")) as f:
            best_json = json.load(f)
    out = dict(
        start_score=start_score, best_score=tuple(trainer.best_eval_score), best_json=best_json,
        best_steps=best_steps, auto_steps=auto_steps, freezes=freezes,
        iteration=int(trainer.train_state.iteration), train_step=int(trainer.train_state.train_step),
        nan_events=trainer._nan_events, frozen=trainer._frozen, logstd=logstd.tolist(),
    )
    trainer.close()
    return out


def _both(tmp_path, monkeypatch, evals, losses, prefill_score=None, **knobs):
    def settings(module):
        base = dict(num_iterations=len(losses), eval_interval=1, eval_envs=2,
                    checkpoint_interval=3, rich_scene=False)
        base.update(knobs)
        return module.TrainerSettings(
            model_name="m", models_root=str(tmp_path / module.__name__.split(".")[0]), **base)

    def config(module):
        return module.PPOConfig(**SMALL)

    results = []
    for trainer_cls, module, ppo_module in ((j_loop.Trainer, j_loop, j_ppo),
                                            (loop.Trainer, loop, ppo)):
        if prefill_score is not None:
            d = tmp_path / module.__name__.split(".")[0] / "m"
            d.mkdir(parents=True)
            (d / "best_score.json").write_text(json.dumps(prefill_score))
        with monkeypatch.context() as mp:
            results.append(_run(trainer_cls, module, ppo_module, settings, config, evals, losses, mp))
    return results


# Evals at iterations 0..8 (iteration 5's NaN rolls back and 6 follows).
EVALS = [
    _eval(10.0, laps=0.50, distance=600.0),
    _eval(900.0, laps=2.86, distance=3000.0),  # a crawler: many laps, unfinished
    _eval(50.0, laps=1.50, distance=3000.0, finished=1.0),  # a finisher
    _eval(60.0, laps=1.50, distance=2000.0, finished=1.0),
    _eval(52000.0, laps=3.0, distance=3000.0, finished=1.0, overtakes=4.5),
    _eval(69000.0, laps=3.0, distance=3000.0, finished=1.0, overtakes=0.0),
    _eval(70.0, laps=3.0, distance=3000.0, finished=1.0, overtakes=4.5),
    _eval(80.0, laps=3.0, distance=3000.0, finished=1.0, overtakes=4.5),
]
LOSSES = [0.5, 0.4, 0.3, 0.2, 0.1, math.nan, 0.1, 0.1]


@pytest.mark.parametrize("best_key", ["progress", "finished_first", "finished_overtakes"])
def test_trainer_loop_matches_jax(tmp_path, monkeypatch, best_key):
    """Best-checkpoint steps, best_score.json, the distance freeze, the NaN
    rollback (to autosave step 3) and the autosave stream agree."""
    j, t = _both(tmp_path, monkeypatch, EVALS, LOSSES, best_key=best_key,
                 freeze_on_solve=2, solve_metric="distance")
    assert t == j
    assert t["nan_events"] == 1 and t["iteration"] == len(LOSSES)
    assert True in t["freezes"] and t["freezes"][0] is False


def test_trainer_freeze_on_laps_and_nan_without_checkpoint(tmp_path, monkeypatch):
    """solve_metric "auto" (laps on the lap env); a NaN before any autosave
    rolls back to the best checkpoint."""
    evals = [_eval(1.0, laps=3.0), _eval(2.0, laps=3.0), _eval(3.0, laps=0.5), _eval(4.0, laps=3.0)]
    j, t = _both(tmp_path, monkeypatch, evals, [0.1, math.nan, 0.1, 0.1], freeze_on_solve=1)
    assert t == j
    assert t["nan_events"] == 1


def test_trainer_nan_with_no_checkpoint_keeps_the_state(tmp_path, monkeypatch):
    """No evals and no autosave yet: the rollback keeps the state from
    before the poisoned iteration, with the iteration counter moved on."""
    j, t = _both(tmp_path, monkeypatch, [], [0.1, math.nan, 0.1], eval_interval=0)
    assert t == j
    assert t["logstd"] == [2.0, 2.0] and t["iteration"] == 3  # log(initial_std 1) + 2 updates
    assert t["train_step"] == 2 * 12  # the rolled-back iteration counted no updates


def test_best_key_length_mismatch_resets_bar(tmp_path, monkeypatch):
    """A 2-component best_score.json under best_key finished_first starts
    the bar fresh in both Trainers."""
    j, t = _both(tmp_path, monkeypatch, [_eval(5.0, laps=1.0)], [0.1], prefill_score=[3.0, 100.0],
                 best_key="finished_first")
    assert t == j
    assert t["start_score"] == (-math.inf,) * 3


def test_resume_continues_counters_and_restart(tmp_path):
    """A real (tiny) run on the port: a second Trainer resumes the autosave
    with its counters and weights; `restart` deletes the model dir. The
    Trainer keeps float32 exact on the card (TF32 off)."""
    settings = loop.TrainerSettings(model_name="r", models_root=str(tmp_path), num_iterations=2,
                                    eval_interval=0, checkpoint_interval=1, rich_scene=False)
    config = ppo.PPOConfig(**SMALL)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    t1 = loop.Trainer(settings, config, device="cpu")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    t1.train()
    w = t1.train_state.model.pi.dense[0].weight.detach().clone()
    steps = (t1.train_state.train_step, t1.train_state.total_env_steps)
    t1.close()
    assert t1.autosaver.all_steps() == [1, 2]

    t2 = loop.Trainer(settings, config, device="cpu")
    assert t2.iteration == 2 and (t2.train_state.train_step, t2.train_state.total_env_steps) == steps
    assert torch.equal(t2.train_state.model.pi.dense[0].weight, w)
    t2.train(num_iterations=3)
    assert t2.iteration == 3 and t2.train_state.train_step == 3 * config.updates_per_iteration
    t2.close()

    t3 = loop.Trainer(settings, config, restart=True, device="cpu")
    assert t3.iteration == 0 and t3.autosaver.all_steps() == []
    t3.close()


def test_reward_overrides_compose_with_caller_params(tmp_path):
    """Reward-shape overrides land on a caller-supplied env_params' reward
    and keep its other fields (km/h settings, m/s RewardParams)."""
    from carla_ppo_tpu_torch.envs import track
    from carla_ppo_tpu_torch.envs.types import EnvParams, RewardParams

    params = EnvParams(track=track.make_lap_track(seed=0, device="cpu"),
                       reward=RewardParams(target_speed=30.0))
    settings = loop.TrainerSettings(models_root=str(tmp_path), num_iterations=0,
                                    reward_min_speed=20.0, low_speed_threshold=36.0)
    t = loop.Trainer(settings, ppo.PPOConfig(**SMALL), env_params=params, device="cpu")
    rp = t.env_params.reward
    assert (rp.target_speed, rp.min_speed, rp.max_speed) == (30.0, 20.0, 25.0)
    assert rp.low_speed_threshold == pytest.approx(10.0)
    t.close()


def _track_fields(track):
    return {k: np.asarray(v) for k, v in np_tree(track).items()}


def test_route_trainer_banks_match_jax(tmp_path):
    """The route Trainer's training bank (seed 0), held-out bank (seed 4097,
    same town) and unseen-town bank (town 4097), 64 routes each, props on:
    field for field against the JAX Trainer's."""
    j_settings = j_loop.TrainerSettings(model_name="j", models_root=str(tmp_path), eval_interval=0)
    t_settings = loop.TrainerSettings(model_name="t", models_root=str(tmp_path), eval_interval=0)
    jt = j_loop.Trainer(j_settings, j_ppo.PPOConfig(env_kind="route", **SMALL))
    tt = loop.Trainer(t_settings, ppo.PPOConfig(env_kind="route", **SMALL), device="cpu")
    pairs = [(jt.env_params, tt.env_params)] + [
        (jt._heldout_params[k], tt._heldout_params[k]) for k in ("eval_heldout", "eval_unseen_town")]
    assert sorted(jt._heldout_params) == sorted(tt._heldout_params)
    for jp, tp in pairs:
        assert tp.track.num_tracks == 64
        jf = _track_fields(jp.track)
        for name in ("pos", "fwd", "maneuver", "left_width", "right_width", "length",
                     "prop_class", "prop_lateral", "prop_height", "prop_halfwidth"):
            got = getattr(tp.track, name)
            np.testing.assert_array_equal(np.asarray(got.numpy() if torch.is_tensor(got) else got),
                                          jf[name], err_msg=name)
        assert tp.max_distance_traveled == float(jp.max_distance_traveled)
    # the held-out worlds differ from the training bank
    assert not np.array_equal(tt.env_params.track.pos.numpy(),
                              tt._heldout_params["eval_heldout"].track.pos.numpy())
    jt.close()
    tt.close()


def test_lap_bank_trainer_banks_match_jax(tmp_path):
    """The lap-bank Trainer's training bank (seed 0) and held-out bank (seed
    4097), 16 tracks each, props on: field for field against the JAX
    Trainer's."""
    j_settings = j_loop.TrainerSettings(model_name="j", models_root=str(tmp_path), eval_interval=0)
    t_settings = loop.TrainerSettings(model_name="t", models_root=str(tmp_path), eval_interval=0)
    jt = j_loop.Trainer(j_settings, j_ppo.PPOConfig(env_kind="lap_bank", **SMALL))
    tt = loop.Trainer(t_settings, ppo.PPOConfig(env_kind="lap_bank", **SMALL), device="cpu")
    assert sorted(jt._heldout_params) == sorted(tt._heldout_params) == ["eval_heldout"]
    pairs = [(jt.env_params, tt.env_params), (jt._heldout_params["eval_heldout"],
                                             tt._heldout_params["eval_heldout"])]
    for jp, tp in pairs:
        assert tp.track.num_tracks == 16
        jf = _track_fields(jp.track)
        for name in ("pos", "fwd", "maneuver", "left_width", "right_width", "length",
                     "prop_class", "prop_lateral", "prop_height", "prop_halfwidth"):
            got = getattr(tp.track, name)
            np.testing.assert_array_equal(np.asarray(got.numpy() if torch.is_tensor(got) else got),
                                          jf[name], err_msg=name)
    assert not np.array_equal(tt.env_params.track.pos.numpy(),
                              tt._heldout_params["eval_heldout"].track.pos.numpy())
    jt.close()
    tt.close()


def test_pixel_trainer_warm_starts_once_and_resumes(tmp_path, monkeypatch, capsys):
    """TrainerSettings(obs="pixels") at a tiny size (4 envs, horizon 4):
    the first Trainer warm-starts from the converted de-prop VAE and trains
    one iteration; a second resumes the autosave with both Adam groups'
    counts and moments, does not warm-start again, and trains on."""
    from carla_ppo_tpu_torch.models import vae_common
    from carla_ppo_tpu_torch.training import pixels

    vae_dir = REPO / "models" / "torch" / "vae_models" / (
        "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data")
    settings = loop.TrainerSettings(
        model_name="px", models_root=str(tmp_path), num_iterations=1, eval_interval=0,
        checkpoint_interval=1, obs="pixels", warm_start_vae=str(vae_dir), deprop_aux=True,
        policy_dtype="mixed")
    config = ppo.PPOConfig(horizon=4, num_envs=4, num_minibatches=2)
    warm = []
    real = pixels.warm_start_from_vae
    monkeypatch.setattr(pixels, "warm_start_from_vae", lambda *a: warm.append(1) or real(*a))
    t1 = loop.Trainer(settings, config, device="cpu")
    assert isinstance(t1.train_state, pixels.PixelTrainState) and t1.rollout_model() is None
    vae = vae_common.load_vae(str(vae_dir), device="cpu")
    assert torch.equal(t1.train_state.model.encoder.convs[0].weight, vae.encoder.convs[0].weight)
    m = t1.train()
    assert np.isfinite(m["train_loss/vae_recon"]) and np.isfinite(m["train_grad/encoder_norm"])
    opt1 = t1.train_state.checkpoint_tree()["opt_state"]
    w1 = t1.train_state.model.mean_head.weight.detach().clone()
    t1.close()
    assert warm == [1] and "warm-started perception" in capsys.readouterr().out
    assert all(int(opt1[g]["count"]) == config.updates_per_iteration for g in pixels.GROUPS)

    t2 = loop.Trainer(settings, config, device="cpu")
    assert warm == [1] and t2.iteration == 1  # resumed, not warm-started again
    assert torch.equal(t2.train_state.model.mean_head.weight, w1)
    opt2 = t2.train_state.checkpoint_tree()["opt_state"]
    for g in pixels.GROUPS:
        assert int(opt2[g]["count"]) == int(opt1[g]["count"])
        for k in ("mu", "nu"):
            assert set(opt2[g][k]) == set(opt1[g][k])
            for name in opt1[g][k]:
                assert torch.equal(opt2[g][k][name], opt1[g][k][name]), (g, k, name)
    t2.train(num_iterations=2)
    assert t2.iteration == 2 and all(
        int(t2.train_state.opt_state[g].count) == 2 * config.updates_per_iteration
        for g in pixels.GROUPS)
    t2.close()
