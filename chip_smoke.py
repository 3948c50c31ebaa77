#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (carla_ppo_tpu_torch) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one line each; any failure raises and exits non-zero:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build both CUDA kernels with plain nvcc (seconds taken);
  3. ground-pass kernel vs its plain PyTorch version at B=1024 on fresh
     resets, after 64 driven steps and across the loop's wrap corner:
     mismatched pixels must be 0 (both sides round every op on its own:
     the kernel is built with -fmad=false);
  4. composite kernel vs its plain version on the same batches (props on):
     exact int32 equality;
  5. kernel and plain times at B=1024 (CUDA events) and each kernel's
     bound on an H100 (bytes over 3.35 TB/s vs instructions over the
     FP32 or INT32 instruction rate);
  6. the main path: latent-observation lap PPO at PPOConfig defaults
     (1024 envs, horizon 128, 3 epochs x 4 minibatches) with a seeded
     frozen ConvVAE (de-prop seg VAE widths: 1 channel, z 64, 32/64/128/256)
     and a seeded 500/300 ActorCritic: 2 train_iterations, then a greedy
     evaluate of 300 steps; both kernels must have launched on that path, losses and
     returns must be finite; env-steps/s from CUDA events, and the split of
     each iteration into rollout and update;
  7. where a rollout step's time goes: the real functions that
     `ppo.rollout` calls are bracketed by CUDA events for 20 steps, then
     torch.profiler reads kernel time by name over 10 more;
  8. the kernels line (JSON), then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Float32 matmuls and convolutions run in full float32 (TF32 off for both).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from collections import defaultdict

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# The data sheet's 67 TFLOP/s of float32 outside the tensor cores is 132 SMs
# x 128 FP32 lanes x 1.98 GHz x 2, an FMA counted as two operations. The
# kernels are built with -fmad=false and contain no FMA, so an operation is one
# instruction on one FP32 lane; int32 min/max run on the 64 INT32 lanes of an SM.
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
BATCH = 1024
EVAL_STEPS = 300  # one evaluate chunk: every step runs, also after all envs finished
STAGE_STEPS = 20
PROFILE_STEPS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def timed_stages(torch, targets):
    """Replace each (owner, attribute, stage) of `targets` with a wrapper that
    records a CUDA event before and after the real call, and restore them on
    exit. Yields {stage: [(start event, end event, host seconds to enqueue)]}."""
    spans = defaultdict(list)
    saved = []
    for owner, attr, stage in targets:
        real = getattr(owner, attr)

        def timed(*args, _real=real, _stage=stage, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            out = _real(*args, **kwargs)
            end.record()
            spans[_stage].append((start, end, time.perf_counter() - h0))
            return out

        saved.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, timed)
    try:
        yield spans
    finally:
        for owner, attr, old in reversed(saved):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)


def span_ms(spans) -> tuple[float, float]:
    """(device ms between each span's events, host ms to enqueue), summed."""
    return (sum(s.elapsed_time(e) for s, e, _ in spans), sum(h for _, _, h in spans) * 1e3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from carla_ppo_tpu_torch.envs import lap_env, track
    from carla_ppo_tpu_torch.envs.types import EnvParams, VehicleState
    from carla_ppo_tpu_torch.models.policy import ActorCritic
    from carla_ppo_tpu_torch.models.vae import VAE
    from carla_ppo_tpu_torch.ops import rasterizer as R
    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC
    from carla_ppo_tpu_torch.training import ppo
    from carla_ppo_tpu_torch.utils import cuda_build
    from carla_ppo_tpu_torch.utils.device import make_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load_library()
    log(f"[build] {lib_path} ready in {time.perf_counter() - t0:.2f} s")

    # 3./4. Parity at B=1024.
    cam, style = R.CameraConfig(), R.RoadStyle()
    params = EnvParams(track=track.make_lap_track(seed=0, props=True, device=dev))
    L = params.track.length
    gen = make_generator(0, dev)
    fresh = lap_env.reset(params, gen, checkpoint_idx=torch.arange(BATCH, device=dev) * 37)
    driven = fresh
    for _ in range(64):
        act = torch.rand(BATCH, 2, generator=gen, device=dev)
        act[:, 0] = act[:, 0] * 0.6 - 0.3
        driven, _ = lap_env.autoreset_step(driven, act, params, gen, obs_fn=None)
    wrap_idx = (L - BATCH // 2 + torch.arange(BATCH, device=dev)).to(torch.int32)
    row = torch.remainder(wrap_idx, L).long()
    fwd = params.track.fwd[row]
    wrap = dataclasses.replace(
        fresh, waypoint_idx=wrap_idx,
        vehicle=VehicleState.create(params.track.pos[row].clone(), torch.atan2(fwd[:, 1], fwd[:, 0])),
    )
    batches = {"fresh": fresh, "driven": driven, "wrap": wrap}
    slab, stripes, sky_px, depth_rows = R._device_layout(cam, str(dev))
    consts = R.style_constants(style)
    hw = cam.height * cam.width
    timing_inputs = {}
    errs = {"ground_pass": 0, "composite": 0}  # max |kernel - plain| over class ids
    for name, states in batches.items():
        win_cols, payload = R.prep_windows(states, params, cam)
        plain = R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, hw, consts)
        got = RC.ground_pass_cuda(win_cols, payload, slab, stripes, sky_px, hw, consts)
        torch.cuda.synchronize()
        errs["ground_pass"] = max(errs["ground_pass"], int((got - plain).abs().max()))
        bad = int((got != plain).sum())
        log(f"[ground_pass parity] {name}: B={BATCH} mismatched pixels {bad} of {got.numel()}")
        if bad:
            raise AssertionError(f"ground-pass kernel disagrees with its plain version on {name}")
        rows = R.prep_candidates(states, params, cam)
        c_plain = R.composite_plain(rows, depth_rows, got, cam.width)
        c_got = RC.composite_cuda(rows, depth_rows, got, cam.width)
        torch.cuda.synchronize()
        errs["composite"] = max(errs["composite"], int((c_got - c_plain).abs().max()))
        c_bad = int((c_got != c_plain).sum())
        drawn = int((c_got != got).sum())
        log(f"[composite parity] {name}: B={BATCH} mismatched pixels {c_bad}, billboard pixels {drawn}")
        if c_bad or not drawn:
            raise AssertionError(f"composite kernel check failed on {name}")
        timing_inputs[name] = (win_cols, payload, rows, got)

    # 5. Kernel times at the main path's shape (the driven batch).
    win_cols, payload, rows, ground = timing_inputs["driven"]
    g_ms = cuda_ms(torch, lambda: RC.ground_pass_cuda(win_cols, payload, slab, stripes, sky_px, hw, consts), 50)
    g_plain_ms = cuda_ms(torch, lambda: R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, hw, consts), 3, 1)
    c_ms = cuda_ms(torch, lambda: RC.composite_cuda(rows, depth_rows, ground, cam.width), 50)
    c_plain_ms = cuda_ms(torch, lambda: R.composite_plain(rows, depth_rows, ground, cam.width), 3, 1)
    n_dist = sum(K * P for K, _, P in stripes.tolist())  # distance evaluations per env
    ground_px = slab.shape[1]
    g_bytes = 4 * (win_cols.numel() + payload.numel() + slab.numel() + stripes.numel() + BATCH * hw)
    g_ops = BATCH * (6 * n_dist + 40 * ground_px)  # sub,sub,mul,mul,add,cmp per distance; ~40 per pixel tail
    c_bytes = 4 * (rows.numel() + depth_rows.numel() + 2 * BATCH * hw)
    c_ops = 2 * BATCH * hw * rows.shape[1]  # one int32 max + one min per candidate-pixel
    bounds = {}
    for name, nbytes, ops, rate in (("ground_pass", g_bytes, g_ops, FP32_OPS_PER_S),
                                    ("composite", c_bytes, c_ops, INT32_OPS_PER_S)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        log(f"[bound] {name}: {nbytes} bytes -> {t_bytes:.6f} ms, {ops} ops at {rate:.4g}/s "
            f"-> {t_ops:.6f} ms")
    log(f"[timing] {smi}: ground_pass {g_ms:.6f} ms (plain {g_plain_ms:.3f} ms), "
        f"composite {c_ms:.6f} ms (plain {c_plain_ms:.3f} ms) at B={BATCH}")
    del timing_inputs, batches, fresh, driven, wrap

    # 6. The main path.
    seed_gen = make_generator(1, "cpu")  # weights are made on the host, then moved
    vae = VAE(source_shape=(cam.height, cam.width, 1), z_dim=64, generator=seed_gen).to(dev).eval()
    latent = ppo.LatentObs(vae_model=vae)
    config = ppo.PPOConfig()
    model = ActorCritic(latent.obs_dim, generator=seed_gen).to(dev)
    train_state = ppo.create_train_state(model, config, make_generator(2, dev))
    envs = ppo.init_env_batch(params, config.num_envs, train_state.generator)
    RC.reset_launch_counts()
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    start.record()
    metrics = []
    with timed_stages(torch, [(ppo, "rollout", "rollout"), (ppo, "ppo_update", "update")]) as phases:
        for _ in range(2):
            train_state, envs, m = ppo.train_iteration(train_state, envs, params, config,
                                                       latent_obs=latent)
            metrics.append(m)
    mid.record()
    ev = ppo.evaluate(model, params, make_generator(3, dev), num_envs=config.num_envs,
                      max_steps=EVAL_STEPS, config=config, latent_obs=latent, chunk=EVAL_STEPS)
    end.record()
    torch.cuda.synchronize()
    launches = dict(RC.LAUNCHES)
    train_s = start.elapsed_time(mid) / 1e3
    eval_s = mid.elapsed_time(end) / 1e3
    for i, m in enumerate(metrics):
        vals = {k: m[k].item() for k in ("train_loss/loss", "train_loss/policy", "train_loss/value",
                                         "train/returns", "train/approx_kl", "train/reward")}
        log(f"[train] iteration {i}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items()))
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite training metrics {bad}")
    obs = ppo.make_obs_fn(latent, config)(envs, params)
    if obs.shape != (config.num_envs, latent.obs_dim) or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"bad latent observation batch {tuple(obs.shape)}")
    ev_vals = {k: v.item() for k, v in ev.items() if v.ndim == 0}
    log("[eval] " + " ".join(f"{k}={v:.6g}" for k, v in ev_vals.items()))
    if not all(math.isfinite(v) for v in ev_vals.values()):
        raise AssertionError("non-finite eval metrics")
    log(f"[launches] main path: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    steps = 2 * config.horizon * config.num_envs
    log(f"[throughput] {smi}: train {steps} env-steps in {train_s:.3f} s = "
        f"{steps / train_s:.1f} env-steps/s (rollout + update); greedy eval {EVAL_STEPS} steps "
        f"x {config.num_envs} envs in {eval_s:.3f} s = {EVAL_STEPS * config.num_envs / eval_s:.1f} "
        f"env-steps/s (envs that finished stay frozen but are still rendered)")
    for name in ("rollout", "update"):
        per_it = ", ".join(f"{s.elapsed_time(e):.3f} ms ({h * 1e3:.3f} ms host)"
                           for s, e, h in phases[name])
        log(f"[throughput] {smi}: {name} of iterations 0, 1 between CUDA events: {per_it}")

    # 7. Where a rollout step's time goes, on the real functions of ppo.rollout.
    gen = train_state.generator
    stages = [(model, "sample", "policy"), (lap_env, "autoreset_step", "env"),
              (R, "prep_windows", "prep_windows"), (R, "ground_pass", "ground_pass"),
              (R, "prep_candidates", "prep_candidates"), (R, "composite", "composite"),
              (R, "seg_to_obs", "seg_to_obs"), (vae, "encode", "vae_encode")]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with timed_stages(torch, stages) as spans:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        envs, _, _, _ = ppo.rollout(model, envs, params, gen, STAGE_STEPS, config, latent_obs=latent)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / STAGE_STEPS
    log(f"[stages] {smi}: ppo.rollout, {config.num_envs} envs, {STAGE_STEPS} steps: "
        f"{step_ms:.3f} ms per step between CUDA events, "
        f"{(time.perf_counter() - h0) * 1e3 / STAGE_STEPS:.3f} ms host; per stage, ms per step "
        "between the events around each call (device time plus any wait for the host) "
        "and host ms to enqueue it:")
    staged = 0.0
    for _, _, name in stages:
        d_ms, h_ms = span_ms(spans[name])
        staged += d_ms
        log(f"[stages]   {name:16s} {len(spans[name]):3d} calls  {d_ms / STAGE_STEPS:8.3f} ms  "
            f"host {h_ms / STAGE_STEPS:8.3f} ms")
    log(f"[stages]   {'rest of rollout':16s}            {step_ms - staged / STAGE_STEPS:8.3f} ms")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        envs, _, _, _ = ppo.rollout(model, envs, params, gen, PROFILE_STEPS, config,
                                    latent_obs=latent)
        torch.cuda.synchronize()
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.device_time_total / 1e3 / PROFILE_STEPS
            by_name[e.name][1] += 1 / PROFILE_STEPS
    busy_ms = sum(ms for ms, _ in by_name.values())
    log(f"[stages] torch.profiler over {PROFILE_STEPS} more steps: {busy_ms:.3f} ms of device "
        f"kernels per step in {sum(n for _, n in by_name.values()):.1f} kernels; over the "
        f"{step_ms:.3f} ms step above (a run without the profiler) that is "
        f"{100 * busy_ms / step_ms:.1f}% device busy")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[stages]   {ms:8.4f} ms/step  {n:5.1f}/step  {name[:90]}")

    # 8. Results.
    times = {"ground_pass": (g_ms, g_plain_ms), "composite": (c_ms, c_plain_ms)}
    sources = {"ground_pass": ("carla_ppo_tpu_torch/csrc/ground_pass.cu",
                               "carla_ppo_tpu/ops/rasterizer_pallas.py:698"),
               "composite": ("carla_ppo_tpu_torch/csrc/composite.cu",
                             "carla_ppo_tpu/ops/rasterizer_pallas.py:1290")}
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": launches[name], "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name in ("ground_pass", "composite")
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
