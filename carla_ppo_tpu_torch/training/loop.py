"""Training orchestration: the host-side loop around train_iteration (port
of carla_ppo_tpu/training/loop.py).

Eval every `eval_interval` iterations, a best-only checkpoint stream keyed
on the eval score (persisted in best_score.json), a periodic autosave
stream, resume from the newer of the two, TensorBoard scalars, the
solve-aware freeze and the non-finite-loss rollback, as the JAX Trainer
does. Counters live inside the checkpointed TrainState, so a resume
continues the numbering.

Ported: `obs` "vector" (and `obs_fn` "vector_npc"), "latent" (seg or rgb
`vae_source`) and "pixels" (the pixel agent trained with the joint VAE,
training/pixels.py, warm-started from a VAE on fresh runs), `env_kind`
"lap", "route" and "lap_bank", NPC traffic on the lap env, on one device
or data parallel over `num_devices` ranks (parallel/train_dp.py), and
`record_eval`: after each eval a greedy episode through the interactive
env (envs/gym_api, training/eval_host) is written to
videos/iteration<N>.avi (`record_eval_video`, which cli.run_eval also
calls). `Trainer(..., device=, dp=)` are the additions: the port runs on the card
unless the caller asks for the CPU, and a data-parallel Trainer is one
rank of a process group that the caller set up (cli.train spawns the
ranks, or joins torchrun's group) and passes as `dp`.

Under data parallel every rank builds the same Trainer and holds its slice
of the env batch; rank 0's state is broadcast at the start, after a
restore and after a NaN rollback (train_dp.replicate). Rank 0 alone
writes checkpoints, best_score.json and metrics and prints; the others wait
at a barrier after each save. The greedy eval is data parallel when
`eval_envs` divides over the ranks, else rank 0 runs it alone and the
others take its metrics, so every rank makes the same best-checkpoint and
freeze decisions. Rank 0 alone records the eval video; the others wait at
a barrier after it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from carla_ppo_tpu_torch.envs import lap_bank_env, route_env, route_planner
from carla_ppo_tpu_torch.envs import track as track_mod
from carla_ppo_tpu_torch.envs.observations import obs_dim_for
from carla_ppo_tpu_torch.envs.types import EnvParams
from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic
from carla_ppo_tpu_torch.models.policy import ActorCritic
from carla_ppo_tpu_torch.parallel import train_dp
from carla_ppo_tpu_torch.parallel.mesh import DataParallel
from carla_ppo_tpu_torch.training import pixels, ppo
from carla_ppo_tpu_torch.utils.checkpoint import Checkpointer
from carla_ppo_tpu_torch.utils.device import exact_float32, make_generator, resolve_device
from carla_ppo_tpu_torch.utils.metrics import MetricsWriter

POLICY_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "mixed": torch.float32}


@dataclasses.dataclass
class TrainerSettings:
    """Driver-level knobs: the same fields and defaults as the JAX
    TrainerSettings (see its docstrings for what each one is for)."""

    model_name: str = "ppo_lap"
    models_root: str = "models"
    num_iterations: int = 0  # <= 0: train forever
    eval_interval: int = 5  # iterations between evals; <= 0 disables them
    record_eval: bool = False  # a video of one greedy episode after each eval
    eval_envs: int = 4
    # 3 laps (~3.5 km) at 15+ km/h: a smaller cap truncates a slow but
    # stable policy's episodes and under-reports laps.
    eval_max_steps: int = 26_000
    checkpoint_interval: int = 25  # autosave period (iterations)
    seed: int = 0
    track_seed: int = 0
    num_devices: int = 1  # data-parallel ranks; <= 0: every visible card
    num_tracks: int = 16  # lap_bank circuits
    rich_scene: bool = True  # roadside props (cameras only)
    num_npcs: int = 0
    npc_min_speed: float = 4.0
    npc_max_speed: float = 7.0
    fps: int = 30
    action_smoothing: float = 0.0
    reward_fn: str = "reward_speed_centering_angle_multiply"
    # "vector", "latent" or "pixels"; None: latent when vae_model is set,
    # else vector.
    obs: Optional[str] = None
    vae_model: Optional[str] = None
    vae_model_type: Optional[str] = None
    vae_z_dim: Optional[int] = None
    vae_source: str = "seg"
    vae_scale: float = 1e-4  # pixels only
    deprop_aux: bool = False  # pixels only
    warm_start_vae: Optional[str] = None  # pixels only
    # Compute dtype of the policy / value MLPs and the frozen VAE encoder:
    # "float32", "bfloat16", or "mixed" (a bfloat16 rollout with a float32
    # update). Params and the Gaussian math stay float32 either way.
    policy_dtype: str = "float32"
    freeze_on_solve: int = 0  # consecutive solved evals that freeze updates
    solve_laps: float = 3.0
    solve_metric: str = "auto"  # "laps", "distance", "auto" (distance on route)
    solve_distance: float = 2995.0
    best_key: str = "progress"  # "finished_first", "finished_overtakes"
    reward_min_speed: Optional[float] = None
    reward_target_speed: Optional[float] = None
    reward_max_speed: Optional[float] = None
    pass_bonus: Optional[float] = None
    blocked_scale: Optional[float] = None
    block_range: Optional[float] = None
    low_speed_threshold: Optional[float] = None  # km/h
    # NPC lane keeping (EnvParams.npc_keep_lat / npc_keep_gain).
    npc_keep_lat: float = 0.0
    npc_keep_gain: float = 0.0
    stall_timeout_s: float = 0.0  # 0 = no watchdog
    junction_spawn_prob: float = 0.0
    heldout_eval: int = 1  # every Nth eval also on never-trained worlds
    heldout_seed_offset: int = 4097


def check_ported(settings: TrainerSettings, config: ppo.PPOConfig) -> None:
    """Raise for settings the Trainer cannot run."""
    if settings.policy_dtype not in POLICY_DTYPES:
        raise ValueError(f"unknown policy_dtype {settings.policy_dtype!r}")


def reseeded_generator(seed: int, iteration: int, device: torch.device) -> torch.Generator:
    """A generator seeded from (seed, iteration): the NaN rollback's fresh
    stream, in place of the JAX package's fold_in(rng, iteration). The two
    streams differ; only the rule (a new stream per rollback) is the same."""
    state = np.random.SeedSequence([int(seed), int(iteration)]).generate_state(2, np.uint32)
    return make_generator(int(state[0]) << 32 | int(state[1]), device)


def world_size_for(settings: TrainerSettings, device: torch.device, dp: Optional[DataParallel]) -> int:
    """The ranks `settings.num_devices` asks for: <= 0 means every visible
    card (the group's size where one is given, one rank on the CPU)."""
    if settings.num_devices > 0:
        return settings.num_devices
    if dp is not None:
        return dp.world_size
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _cloned(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class Trainer:
    def __init__(
        self,
        settings: TrainerSettings,
        config: ppo.PPOConfig,
        restart: bool = False,
        env_params: Optional[EnvParams] = None,
        device: str | torch.device = "cuda",
        dp: Optional[DataParallel] = None,
    ):
        check_ported(settings, config)
        self.settings = settings
        self.config = config
        n_dev = world_size_for(settings, resolve_device(device if dp is None else dp.device), dp)
        if n_dev > 1:
            if config.num_envs % n_dev:
                raise ValueError(f"num_envs={config.num_envs} not divisible by num_devices={n_dev}")
            if dp is None or dp.world_size != n_dev:
                raise RuntimeError(
                    f"num_devices={n_dev} needs a process group of {n_dev} ranks, one Trainer per "
                    "rank: start them with `python -m carla_ppo_tpu_torch.cli.train --num_devices "
                    f"{n_dev} ...` (it spawns the ranks) or `torchrun --nproc_per_node {n_dev} -m "
                    "carla_ppo_tpu_torch.cli.train ...`, or pass dp=parallel.mesh.init(...)")
        elif dp is not None and dp.world_size > 1:
            raise ValueError(f"a group of {dp.world_size} ranks but num_devices={n_dev}")
        self.dp = dp if n_dev > 1 else None
        self.is_main = self.dp is None or self.dp.is_main
        self.device = dev = resolve_device(device) if self.dp is None else self.dp.device
        exact_float32()

        self.model_dir = os.path.join(settings.models_root, settings.model_name)
        if restart and self.is_main and os.path.isdir(self.model_dir):
            shutil.rmtree(self.model_dir)
        self._barrier()
        self.checkpoint_dir = os.path.join(self.model_dir, "checkpoints")
        self.log_dir = os.path.join(self.model_dir, "logs")
        self.video_dir = os.path.join(self.model_dir, "videos")
        for d in (self.checkpoint_dir, self.log_dir, self.video_dir):
            os.makedirs(d, exist_ok=True)

        # Env params.
        env_common = dict(
            dt=1.0 / settings.fps,
            action_smoothing=settings.action_smoothing,
            reward_fn=settings.reward_fn,
            num_npcs=settings.num_npcs,
            npc_min_speed=settings.npc_min_speed,
            npc_max_speed=settings.npc_max_speed,
            terminate_on_collision=settings.num_npcs > 0,
            render_npc_billboards=settings.num_npcs > 0,
            npc_keep_lat=settings.npc_keep_lat,
            npc_keep_gain=settings.npc_keep_gain,
            junction_spawn_prob=settings.junction_spawn_prob,
        )
        rp_overrides = {
            k: v
            for k, v in dict(
                min_speed=settings.reward_min_speed,
                target_speed=settings.reward_target_speed,
                max_speed=settings.reward_max_speed,
                pass_bonus=settings.pass_bonus,
                blocked_scale=settings.blocked_scale,
                block_range=settings.block_range,
                # km/h in the settings, m/s in RewardParams.
                low_speed_threshold=(
                    settings.low_speed_threshold / 3.6
                    if settings.low_speed_threshold is not None else None
                ),
            ).items()
            if v is not None
        }
        self._heldout_params: Dict[str, EnvParams] = {}
        off = settings.heldout_seed_offset
        if env_params is not None:
            self.env_params = env_params
        elif config.env_kind == "route":
            town = route_planner.make_town(seed=settings.track_seed)
            bank = route_planner.make_route_bank(
                town, seed=settings.track_seed, props=settings.rich_scene, device=dev)
            self.env_params = route_env.route_env_params(bank, **env_common)
            if settings.heldout_eval > 0:
                # Same town, never-trained routes (disjoint route seed)...
                ho = route_planner.make_route_bank(
                    town, seed=settings.track_seed + off, props=settings.rich_scene, device=dev)
                self._heldout_params["eval_heldout"] = route_env.route_env_params(ho, **env_common)
                # ...and a different town entirely.
                town2 = route_planner.make_town(seed=settings.track_seed + off)
                ho2 = route_planner.make_route_bank(
                    town2, seed=settings.track_seed + off, props=settings.rich_scene, device=dev)
                self._heldout_params["eval_unseen_town"] = route_env.route_env_params(
                    ho2, **env_common)
        elif config.env_kind == "lap_bank":
            bank = lap_bank_env.make_lap_bank(
                n_tracks=settings.num_tracks, base_seed=settings.track_seed,
                props=settings.rich_scene, device=dev)
            self.env_params = lap_bank_env.lap_bank_params(bank, **env_common)
            if settings.heldout_eval > 0:
                ho = lap_bank_env.make_lap_bank(
                    n_tracks=settings.num_tracks, base_seed=settings.track_seed + off,
                    props=settings.rich_scene, device=dev)
                self._heldout_params["eval_heldout"] = lap_bank_env.lap_bank_params(
                    ho, **env_common)
        else:
            self.env_params = EnvParams(
                track=track_mod.make_lap_track(
                    seed=settings.track_seed, props=settings.rich_scene, device=dev),
                **env_common,
            )

        # Reward-shape overrides compose with whatever reward the resolved
        # env_params carries, a caller-supplied one included.
        if rp_overrides:
            def with_overrides(p: EnvParams) -> EnvParams:
                return dataclasses.replace(
                    p, reward=dataclasses.replace(p.reward, **rp_overrides))

            self.env_params = with_overrides(self.env_params)
            self._heldout_params = {k: with_overrides(p) for k, p in self._heldout_params.items()}

        # Observations: ground-truth vector, frozen-VAE latent or pixels.
        self.obs_mode = settings.obs or ("latent" if settings.vae_model else "vector")
        if self.obs_mode not in ("vector", "latent", "pixels"):
            raise ValueError(f"unknown obs mode {self.obs_mode!r}")
        if self.obs_mode == "latent" and not settings.vae_model:
            raise ValueError("--obs latent requires --vae_model")
        # "mixed": the update model computes in float32 and the rollout acts
        # with a bfloat16-trunk twin of it (train(): rollout_model()). The
        # pixel agent computes in float32 whatever policy_dtype says, as the
        # JAX Trainer builds it.
        mixed = settings.policy_dtype == "mixed"
        self._rollout_dtype = torch.bfloat16 if mixed and self.obs_mode != "pixels" else None
        self.latent_obs = None
        self.pix = None
        model_gen = make_generator(settings.seed, "cpu")
        if self.obs_mode == "pixels":
            self.pix = pixels.PixelConfig(vae_scale=settings.vae_scale,
                                          deprop_aux=settings.deprop_aux)
            model = PixelActorCritic(initial_std=config.initial_std, generator=model_gen)
        else:
            if self.obs_mode == "latent":
                # policy_dtype is also the frozen encoder's compute dtype; the
                # encoder runs only in rollouts and evals, so "mixed" puts it
                # in bfloat16 with the behaviour policy.
                vae_dtype = torch.bfloat16 if mixed else POLICY_DTYPES[settings.policy_dtype]
                vae = vae_common.load_vae(settings.vae_model, settings.vae_z_dim,
                                          settings.vae_model_type, dtype=vae_dtype, device=dev)
                self.latent_obs = ppo.LatentObs(vae_model=vae, source=settings.vae_source)
                obs_dim = self.latent_obs.obs_dim
            else:
                obs_dim = obs_dim_for(config.obs_fn)
            model = ActorCritic(obs_dim, initial_std=config.initial_std, generator=model_gen,
                                compute_dtype=POLICY_DTYPES[settings.policy_dtype])
        create = pixels.create_pixel_train_state if self.pix is not None else ppo.create_train_state
        self.train_state = create(model.to(dev), config, make_generator(settings.seed, dev))
        self.env_states = self._init_envs(self.train_state.generator)

        # Two checkpoint streams: `checkpoints/` holds best-eval models only,
        # `autosave/` periodic crash-recovery snapshots. Separate managers,
        # or the periodic saves would prune the best.
        self.checkpointer = Checkpointer(self.checkpoint_dir)
        self.autosaver = Checkpointer(os.path.join(self.model_dir, "autosave"))
        restored = None
        for ck in (self.autosaver, self.checkpointer):
            candidate = ck.restore_latest(self.train_state)
            if candidate is not None and (restored is None or candidate.iteration > restored.iteration):
                restored = candidate
        if restored is not None:
            self.train_state = restored
            self._print(f"resumed at iteration {restored.iteration} from {self.model_dir}")
        elif self.obs_mode == "pixels" and settings.warm_start_vae:
            pixels.warm_start_from_vae(self.train_state.model,
                                       vae_common.load_vae(settings.warm_start_vae, device=dev))
            self._print(f"warm-started perception from {settings.warm_start_vae}")
        if self.dp is not None:
            train_dp.replicate(self.train_state, self.dp)
            make = (train_dp.make_dp_pixel_train_iteration if self.pix is not None
                    else train_dp.make_dp_train_iteration)
            extra = dict(pix=self.pix) if self.pix is not None else dict(latent_obs=self.latent_obs)
            self._dp_iteration = make(self.dp, config, self.env_params, **extra)

        self.writer = MetricsWriter(self.log_dir, enabled=self.is_main)
        hparams = {**dataclasses.asdict(settings), **dataclasses.asdict(config)}
        self.writer.write_hparams(hparams)

        # The best-eval score persists beside the checkpoints, so a resumed
        # run does not admit entries worse than the historical best.
        self._best_score_path = os.path.join(self.model_dir, "best_score.json")
        score_len = {"finished_first": 3, "finished_overtakes": 4}.get(settings.best_key, 2)
        self.best_eval_score = (-float("inf"),) * score_len
        if os.path.exists(self._best_score_path):
            try:
                with open(self._best_score_path) as f:
                    loaded = tuple(json.load(f))
                if len(loaded) == score_len:
                    self.best_eval_score = loaded
                else:
                    self._print(
                        f"best_score.json has {len(loaded)} components but "
                        f"best_key={settings.best_key!r} ranks by {score_len};"
                        " starting the best-checkpoint bar fresh"
                    )
            except (ValueError, OSError):
                pass
        self._solve_metric = settings.solve_metric
        if self._solve_metric == "auto":
            self._solve_metric = "distance" if config.env_kind == "route" else "laps"
        if self._solve_metric not in ("laps", "distance"):
            raise ValueError(f"unknown solve_metric {settings.solve_metric!r}")
        # Solve-aware freeze state (host-side, not checkpointed).
        self._solve_streak = 0
        self._frozen = False
        self._eval_generator = make_generator(settings.seed + 1, dev)
        self._eval_count = 0
        self._nan_events = 0
        self._watchdog = None
        if settings.stall_timeout_s > 0:
            from carla_ppo_tpu_torch.utils.watchdog import StallWatchdog

            self._watchdog = StallWatchdog(settings.stall_timeout_s)

    @property
    def iteration(self) -> int:
        return int(self.train_state.iteration)

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)

    def _barrier(self) -> None:
        if self.dp is not None:
            self.dp.barrier()

    def _save(self, checkpointer: Checkpointer, step: int) -> None:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if self.is_main:
            checkpointer.save(step, self.train_state)
        self._barrier()

    def _init_envs(self, generator: torch.Generator):
        """Fresh training envs: the whole batch from `generator` (drawn
        alike on every rank), then this rank's slice under data parallel."""
        envs = ppo.init_env_batch(self.env_params, self.config.num_envs, generator,
                                  env_kind=self.config.env_kind)
        return envs if self.dp is None else train_dp.shard_env_batch(envs, self.dp)

    def rollout_model(self) -> Optional[ActorCritic]:
        """The behaviour policy of the "mixed" recipe (a bfloat16 twin of
        the current model), else None."""
        if self._rollout_dtype is None:
            return None
        return self.train_state.model.with_compute_dtype(self._rollout_dtype)

    def _evaluate_on(self, params: EnvParams, data_parallel: bool = False) -> Dict[str, torch.Tensor]:
        if data_parallel:
            kw = dict(model=self.train_state.model, config=self.config, env_params=params,
                      num_envs=self.settings.eval_envs)
            if self.obs_mode == "pixels":
                fn = train_dp.make_dp_pixel_evaluate(self.dp, pix=self.pix, **kw)
            else:
                fn = train_dp.make_dp_evaluate(self.dp, latent_obs=self.latent_obs, **kw)
            return fn(self._eval_generator, self.settings.eval_max_steps)
        if self.obs_mode == "pixels":
            return pixels.evaluate(
                self.train_state.model, params, self._eval_generator,
                num_envs=self.settings.eval_envs, max_steps=self.settings.eval_max_steps,
                config=self.config, pix=self.pix,
            )
        return ppo.evaluate(
            self.train_state.model, params, self._eval_generator,
            num_envs=self.settings.eval_envs, max_steps=self.settings.eval_max_steps,
            config=self.config, latent_obs=self.latent_obs,
        )

    def evaluate(self) -> Dict[str, float]:
        """Greedy eval on the training world, and every `heldout_eval`-th
        time also on the held-out worlds (route / lap_bank); array metrics
        are flattened to one scalar per element (`eval/laps_per_track/i`).
        Under data parallel every rank returns the same metrics: the eval
        is data parallel when `eval_envs` divides over the ranks, else rank
        0 runs it on its device alone and the others take its metrics."""
        if self.dp is not None and self.settings.eval_envs % self.dp.world_size:
            return self.dp.broadcast_object(self._evaluate(False) if self.is_main else None)
        return self._evaluate(self.dp is not None)

    def _evaluate(self, data_parallel: bool) -> Dict[str, float]:
        def on(params):
            if data_parallel:
                return self._evaluate_on(params, data_parallel=True)
            return self._evaluate_on(params)

        metrics = on(self.env_params)
        self._eval_count += 1
        if (
            self._heldout_params
            and self.settings.heldout_eval > 0
            and self._eval_count % self.settings.heldout_eval == 0
        ):
            for prefix, hp in self._heldout_params.items():
                hm = on(hp)
                metrics.update({k.replace("eval/", prefix + "/"): v for k, v in hm.items()})
        flat: Dict[str, float] = {}
        for k, v in metrics.items():
            arr = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            if arr.ndim == 0:
                flat[k] = float(arr)
            else:
                for i, x in enumerate(arr.ravel()):
                    flat[f"{k}/{i}"] = float(x)
        return flat

    def _eval_score(self, eval_metrics: Dict[str, float]) -> tuple:
        """Best-checkpoint ranking: task completion first, reward as the
        tie-breaker (see the JAX TrainerSettings.best_key)."""
        progress = round(eval_metrics.get("eval/laps_completed", 0.0), 2)
        reward = eval_metrics["eval/reward"]
        finished = round(eval_metrics.get("eval/finished", 0.0), 2)
        if self.settings.best_key == "finished_first":
            return (finished, progress, reward)
        if self.settings.best_key == "finished_overtakes":
            return (finished, progress, round(eval_metrics.get("eval/overtakes", 0.0), 2), reward)
        return (progress, reward)

    def _update_freeze(self, it: int, eval_metrics: Dict[str, float]) -> None:
        if self._solve_metric == "distance":
            solved = eval_metrics.get("eval/distance_traveled", 0.0) >= self.settings.solve_distance
        else:
            solved = eval_metrics.get("eval/laps_completed", 0.0) >= self.settings.solve_laps - 1e-2
        self._solve_streak = self._solve_streak + 1 if solved else 0
        should = self._solve_streak >= self.settings.freeze_on_solve
        if should and not self._frozen:
            self._print(f"Iteration {it}: task solved for {self._solve_streak} consecutive evals - "
                        "freezing updates (rollout/eval continue)")
        elif self._frozen and not should:
            bar = (f"{self.settings.solve_distance} m" if self._solve_metric == "distance"
                   else f"{self.settings.solve_laps} laps")
            self._print(f"Iteration {it}: eval fell below {bar} - unfreezing")
        self._frozen = should

    def _eval_and_checkpoint(self, it: int) -> None:
        eval_metrics = self.evaluate()
        if self._watchdog is not None:
            self._watchdog.beat()  # evals can legitimately take long
        self.writer.write_scalars(eval_metrics, it)
        self._print(
            f"Iteration {it} (step {int(self.train_state.train_step)}): "
            f"eval reward {eval_metrics['eval/reward']:.1f}, "
            f"distance {eval_metrics['eval/distance_traveled']:.0f} m, "
            f"laps {eval_metrics['eval/laps_completed']:.2f}"
        )
        if self.settings.record_eval:
            if self.is_main:
                self.record_eval_video(os.path.join(self.video_dir, f"iteration{it}.avi"))
                if self._watchdog is not None:
                    self._watchdog.beat()
            self._barrier()
        eval_score = self._eval_score(eval_metrics)
        if eval_score > self.best_eval_score:
            self.best_eval_score = eval_score
            if self.is_main:
                with open(self._best_score_path, "w") as f:
                    json.dump(list(eval_score), f)
            self._save(self.checkpointer, it)  # best-only
        if self.settings.freeze_on_solve > 0:
            self._update_freeze(it, eval_metrics)

    def record_eval_video(self, filename: str, max_steps: int = 1500) -> float:
        """One greedy episode through the interactive env (a CarlaLapEnv, or
        a CarlaRouteEnv on the route env), rendered to `filename`; returns
        the episode's reward. The env (make_video_env) is built on first
        use, with the JAX Trainer's settings."""
        from carla_ppo_tpu_torch.training.eval_host import run_eval

        if not hasattr(self, "_video_env"):
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
            self._video_env = self.make_video_env()
        return run_eval(self._video_env, self._predict_fn(), video_filename=filename,
                        max_steps=max_steps)

    def make_video_env(self):
        """The interactive env of record_eval_video, on the Trainer's device."""
        from carla_ppo_tpu_torch.envs.gym_api import CarlaLapEnv, CarlaRouteEnv

        cls = CarlaRouteEnv if self.config.env_kind == "route" else CarlaLapEnv
        return cls(
            obs_res=(160, 80),
            encode_state_fn="vector" if self.latent_obs is None else None,
            action_smoothing=self.settings.action_smoothing,
            fps=self.settings.fps,
            track_seed=self.settings.track_seed,
            reward_fn=self.settings.reward_fn,
            device=self.device,
        )

    def _predict_fn(self):
        """predict_fn(env) -> (greedy action [2] numpy, value float) of the
        current model on the env's single state: the pixel policy on the
        rendered frame, the vector observation, or the frozen-VAE latent.
        On a bank (the route env) every observation reads the state's own
        bank row."""
        model = self.train_state.model

        if self.obs_mode == "pixels":
            from carla_ppo_tpu_torch.envs.observations import measurements
            from carla_ppo_tpu_torch.ops import rasterizer

            cam = self.pix.cam

            def observe(state, params):
                cls = rasterizer.render_semantic(state, params, cam)
                return (pixels.frames_input(cls[None]), measurements(state))
        elif self.latent_obs is None:
            from carla_ppo_tpu_torch.envs import lap_env

            obs_fn = self.config.obs_fn

            def observe(state, params):
                return (lap_env.observe(state, params, obs_fn),)
        else:
            encode = vae_common.create_encode_state_fn(self.latent_obs.vae_model,
                                                       source=self.latent_obs.source)

            def observe(state, params):
                return (encode(state, params)[None],)

        @torch.no_grad()
        def fn(env):
            obs = observe(env.state, env.params)
            out = model.policy_value(*obs) if self.obs_mode == "pixels" else model(*obs)
            return out[0][0].cpu().numpy(), float(out[2][0])

        return fn

    def train(self, num_iterations: Optional[int] = None) -> Dict[str, float]:
        """The main loop; returns the last iteration's metrics."""
        target = num_iterations or self.settings.num_iterations
        metrics: Dict[str, float] = {}
        while target <= 0 or self.iteration < target:
            it = self.iteration
            if self._watchdog is not None:
                self._watchdog.beat()
            ei = self.settings.eval_interval
            if ei > 0 and it % ei == 0:
                self._eval_and_checkpoint(it)

            freeze = None
            if self.settings.freeze_on_solve > 0:
                freeze = torch.tensor(self._frozen, device=self.device)
            # train_iteration updates the model in place; this copy is what a
            # rollback returns to when no checkpoint exists yet.
            before = _cloned(self.train_state.checkpoint_tree())
            if self.dp is not None:
                kw = {} if self.pix is not None else dict(rollout_model=self.rollout_model())
                new_state, new_envs, m = self._dp_iteration(self.train_state, self.env_states,
                                                            freeze, **kw)
            elif self.obs_mode == "pixels":
                new_state, new_envs, m = pixels.pixel_train_iteration(
                    self.train_state, self.env_states, self.env_params, self.config, self.pix,
                    freeze=freeze)
            else:
                new_state, new_envs, m = ppo.train_iteration(
                    self.train_state, self.env_states, self.env_params, self.config,
                    latent_obs=self.latent_obs, freeze=freeze, rollout_model=self.rollout_model(),
                )
            metrics = {k: float(v) for k, v in m.items()}
            if freeze is not None:
                metrics["train/frozen"] = float(self._frozen)

            # A non-finite loss poisons the params: roll back to the newest
            # checkpoint (or the state before this iteration) with fresh
            # envs and a fresh generator.
            if not np.isfinite(metrics["train_loss/loss"]):
                self._nan_events += 1
                self.writer.write_scalar("train/nan_events", self._nan_events, it)
                self._print(f"Iteration {it}: non-finite loss detected; rolling back "
                            f"({self._nan_events} events)")
                restored = (self.autosaver.restore_latest(new_state)
                            or self.checkpointer.restore_latest(new_state)
                            or new_state.restored(before))
                restored.generator = reseeded_generator(self.settings.seed, it, self.device)
                restored.shared_generator = None
                restored.iteration = it + 1
                self.train_state = restored
                self.env_states = self._init_envs(restored.generator)
                if self.dp is not None:
                    train_dp.replicate(self.train_state, self.dp)
                continue

            self.train_state, self.env_states = new_state, new_envs
            self.writer.write_scalars(metrics, it)
            if (
                self.settings.checkpoint_interval > 0
                and (it + 1) % self.settings.checkpoint_interval == 0
            ):
                self._save(self.autosaver, it + 1)
        self.writer.flush()
        return metrics

    def close(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
        self.writer.close()
        if hasattr(self, "_video_env"):
            self._video_env.close()
        self.checkpointer.close()
        self.autosaver.close()
