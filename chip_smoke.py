#!/usr/bin/env python3
"""Card smoke of the PyTorch / CUDA port (carla_ppo_tpu_torch): its
correctness drive on one CUDA card, and the kernel-alone times of the
kernels line.

    python3 chip_smoke.py          # from the repository root, one CUDA card

The phases run in this order; each logs what it saw and raises on any check
that fails, so the script exits non-zero. Each phase function's docstring
says what it checks. The speed of training and evaluation is measured by
perfbench/ (its cells, and with --trace 1 the program's spans), not here.
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. the build of the CUDA kernels (one library of five sources, plain nvcc);
  3. camera_parity_phase: the camera kernels against their plain versions
     at B=1024, also with 128 candidates and at B=1;
  4. contracts_phase: the ground pass on the other TPU kernels' contracts;
  5. kernel_times_phase: each camera kernel's card ms, plain ms and bound;
  6. [ssm] ssm_phase: the memory policy's SSM step kernel, its time, and its
     launches in a rollout;
  7. [vae] vae_phase: the frozen VAE encode's kernels on the shipped VAEs,
     and their time;
  8. paths_phase: latent PPO on the lap, RGB-latent lap, route and lap-bank
     paths; entry_phase: the camera's other entry points;
  9. [trainer] trainer_phase: cli.train at full width, resumed;
 10. [pretrained], [rgb_pretrained], [traffic] eval_phase: cli.run_eval of
     the converted agents against the JAX package's CPU evals;
 11. [vae_pipeline] vae_pipeline_phase: collect_data -> train_vae -> load_vae;
 12. [pixels] pixel_phase: pixel PPO through cli.train; [pixel_pretrained]
     eval_phase of the turnkey pixel agent;
 13. [dp] dp_phase: data parallel over two ranks on the card, then world
     size 1 over NCCL;
 14. [agents] agents_phase: roaming agents with traffic lights;
 15. [video] video_phase: greedy episodes through the interactive envs to
     video, and the camera kernels' times at B=1;
 16. [inspect] inspect_phase: the inspection CLIs against the CPU;
 17. the kernels line (JSON, one row per TPU kernel, a row for the
     composite's depth-and-sky mode, one for the SSM step and one for the
     VAE encode; each row's bound_share must not exceed 1.05), then the last
     line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Every bound comes from perfbench/harness/yardstick.py (peaks, least time,
work counts) and yardstick_seq.py (the SSM step's bytes). Float32 matmuls
and convolutions run in full float32 (TF32 off for both).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

BATCH = 1024
ODD_BATCH = 1000
EVAL_STEPS = 300  # one evaluate chunk: every step runs, also after all envs finished
ENTRY_STEPS = 16  # env steps driven through each camera entry point
SSM_SHAPE = (1024, 64, 64, 128)  # [ssm]: envs, and granite-4.0-h-micro's heads, head size, state size
SSM_ROLLOUT_STEPS = 3
VAE_BATCH = 1024  # [vae]: frames an encode, the latent rollout's
PIXEL_CAMERA = dict(height=84, width=84)
CHASE_CAMERA = dict(height=180, width=320, mount_forward=-5.5, mount_height=2.8, pitch_deg=-15.0)
PALLAS = "carla_ppo_tpu/ops/rasterizer_pallas.py"
CSRC = "carla_ppo_tpu_torch/csrc"
REPO = os.path.dirname(os.path.abspath(__file__))
DEPROP_VAE = os.path.join(REPO, "models", "torch", "vae_models",
                          "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data")
RGB_DEPROP_VAE = os.path.join(REPO, "models", "torch", "vae_models",
                              "seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data")
LATENT_AGENT = os.path.join(REPO, "models", "torch", "latent_agent")
ROUTE_AGENT = os.path.join(REPO, "models", "torch", "route_latent")
PIXEL_AGENT = os.path.join(REPO, "models", "torch", "pixel_turnkey")
RGB_AGENT = os.path.join(REPO, "models", "torch", "rgb_latent")
TRAFFIC_AGENT = os.path.join(REPO, "models", "torch", "traffic_agent")
TRAFFIC_STEPS = 3000
TRAFFIC_ENVS = 16
# The traffic agent's eval flags: its training traffic and reward speeds.
TRAFFIC_ARGV = ["--num_npcs", "4", "--obs_fn", "vector_npc", "--npc_keep_lat", "-0.5",
                "--npc_keep_gain", "1.0", "--reward_min_speed", "30", "--reward_target_speed", "38",
                "--reward_max_speed", "55", "--low_speed_threshold", "29"]
VAE_IMAGES = 300
VAE_EPOCHS = 2
# The [pretrained] drive's cap, ~0.7 of a lap (~1-2 min here). The full 3
# laps take ~26,350 steps (3.5-7 min): scripts/export_torch_checkpoints.py
# --reference_eval 30000 and cli.run_eval --eval_max_steps 30000 compare
# them, by hand.
PRETRAINED_STEPS = 6000
PRETRAINED_ENVS = 8
# [pixels]: the README's turnkey pixel recipe at full width; its greedy
# evals (4 envs, every 2 iterations) capped at PIXEL_EVAL_STEPS.
PIXEL_ARGV = ["--obs", "pixels", "--deprop_aux", "1", "--learning_rate", "3e-4",
              "--kl_target", "0.015", "--freeze_on_solve", "2", "--warm_start_vae", DEPROP_VAE,
              "--eval_interval", "2", "--eval_envs", "4"]
PIXEL_EVAL_STEPS = 1024
DP_WORLD = 2
DP_ITERATIONS = 2
DP_DEADLINE_S = 600
# [video]: (tag, agent, TrainerSettings fields, PPOConfig fields, greedy steps)
VIDEO_EPISODES = (
    ("lap", LATENT_AGENT, dict(vae_model=DEPROP_VAE), {}, 1500),
    ("route", ROUTE_AGENT, dict(vae_model=DEPROP_VAE), {"env_kind": "route"}, 500),
    ("rgb", RGB_AGENT, dict(vae_model=RGB_DEPROP_VAE, vae_source="rgb"), {}, 300),
    ("pixels", PIXEL_AGENT, dict(obs="pixels"), {}, 300),
)
VIDEO_CHECK_EVERY = 100  # steps between the kernel-vs-plain checks of an episode's frames
VIDEO_TOLERANCE = 0.02  # distance and reward against the JAX CPU episode
AGENT_STEPS = 1200  # 40 s at 30 fps
AGENT_RENDER_EVERY = 10
AGENT_SPEED_KMH = 18.0
LIGHT_SPAWN_BEFORE = 30  # waypoints (m) before each light
LIGHT_STEPS = 600
# [inspect]: the inspection CLIs on the converted VAEs and latent agent.
RGB_VAE = os.path.join(REPO, "models", "torch", "vae_models", "rgb_bce_cnn_zdim64_beta1_kl_tolerance0.0_data")
INSPECT_DIMS = 10  # inspect_vae --dump --dims: a (10 x 80) x (9 x 160) sheet
INSPECT_FRAMES = 6  # RGB frames for "Set z by image" and vae_plots' reconstructions
INSPECT_OFF_SHARE = 1e-3  # sheet pixels more than 1 level off the CPU's (seg class flips)
INSPECT_TOL = 1e-4  # card against CPU: the agent's numbers, the plot arrays
DECODE_ITERS = 50
TRACE_DECODES = 3  # per VAE: a short device_trace block, as a user's is
TRACE_TRIES = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Card ms a call of `fn`: CUDA events around `reps` calls after
    `warmup`."""
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


def log_bound(label: str, nbytes: float, work) -> tuple[float, str]:
    """perfbench's yardstick.bound of a kernel call, (least ms, what bounds
    it), logged with its bytes term and its operations term (each the
    yardstick's bound of that term alone); `work` is [(operations, their
    rate per second), ...]."""
    from perfbench.harness import yardstick

    log(f"[bound] {label}: {int(nbytes)} bytes -> {yardstick.bound(nbytes, [])[0]:.6f} ms, "
        + " + ".join(f"{int(ops)} ops at {rate:.4g}/s" for ops, rate in work)
        + f" -> {yardstick.bound(0, work)[0]:.6f} ms")
    return yardstick.bound(nbytes, work)


def depth_sky_check(torch, label, got, want, errs):
    """Log and count a depth-and-sky composite's mismatches against its
    plain version (classes, depth bit patterns, sky); raises on any."""
    bad = [int((got[0] != want[0]).sum()),
           int((got[1].view(torch.int32) != want[1].view(torch.int32)).sum()),
           int((got[2] != want[2]).sum())]
    both = torch.isfinite(got[1]) & torch.isfinite(want[1])
    d_err = float((got[1] - want[1])[both].abs().max()) if bool(both.any()) else 0.0
    errs["composite_depth_sky"] = max(errs["composite_depth_sky"], int((got[0] - want[0]).abs().max()),
                                      d_err, int(bad[2] > 0))
    log(f"[composite_depth_sky parity] {label}: B={got[0].shape[0]} mismatched pixels: classes "
        f"{bad[0]}, depth bits {bad[1]}, sky {bad[2]}; billboard depths {int(both.sum())}, sky pixels "
        f"{int(got[2].sum())} of {got[0].numel()}")
    if any(bad):
        raise AssertionError(f"the depth-and-sky composite disagrees with its plain version on {label}")


def reset_launch_counts(RC) -> None:
    """Set the camera kernels' launch counts, the VAE encode's and its
    encoder calls by path to 0."""
    from carla_ppo_tpu_torch.ops import vae_cuda

    RC.reset_launch_counts()
    vae_cuda.LAUNCHES["vae_encode"] = 0
    vae_cuda.CALLS.update(kernel=0, module=0)


def launch_counts(RC) -> dict:
    """The camera kernels' launch counts and the VAE encode's (vae_encode)."""
    from carla_ppo_tpu_torch.ops import vae_cuda

    return {**RC.LAUNCHES, **vae_cuda.LAUNCHES}


def camera_parity_phase(torch, dev):
    """The camera kernels against their plain PyTorch versions at B=1024 on
    three lap batches: fresh resets, after 64 driven steps, and across the
    loop's wrap corner.
    - The ground-pass kernel: 0 mismatched pixels (both sides round every op
      on its own: the kernels are built with -fmad=false). The pose-fed
      ground pass (prep_pose + ground_pass_pose.cu) must equal its plain
      version and the ground-pass kernel's output.
    - The composite kernel (props on): exact int32 equality, and some
      billboard pixels drawn. Then on a batch of N=128 candidates (all four
      32-bit mask words: the driven batch's 72 candidate rows and 56 of the
      wrap batch's), which must also change pixels that the first 96
      candidates alone leave as they are.
    - Its depth-and-sky mode (the RGB camera's, launch_composite_depth_sky)
      against composite_plain(..., return_depth_sky=True) on the three
      batches, at B=1 (the collector's batch) and on the N=128 batch: 0
      mismatched pixels in classes, depth bits and sky; its classes equal
      the class-only mode's.
    Returns (lap params, the generator, the driven batch, max |kernel -
    plain| by kernels-line key, the driven batch's kernel inputs: windows,
    payload, candidate rows, ground frame, pose-fed inputs)."""
    from carla_ppo_tpu_torch.envs import lap_env, track
    from carla_ppo_tpu_torch.envs.types import EnvParams, VehicleState
    from carla_ppo_tpu_torch.ops import rasterizer as R
    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC
    from carla_ppo_tpu_torch.utils.device import make_generator

    cam = R.CameraConfig()
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
    consts = R.style_constants(R.RoadStyle())
    hw = cam.height * cam.width
    inputs = {}
    # max |kernel - plain| over class ids, per row of the kernels line
    errs = defaultdict(int)
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
        starts, table, pose = R.prep_pose(states, params, cam)
        p_plain = R.ground_pass_pose_plain(starts, table, pose, cam.window, slab, stripes, sky_px, hw,
                                           consts)
        p_got = RC.ground_pass_pose_cuda(starts, table, pose, cam.window, slab, stripes, sky_px, hw,
                                         consts)
        torch.cuda.synchronize()
        errs["ground_pass_pose"] = max(errs["ground_pass_pose"], int((p_got - p_plain).abs().max()))
        p_bad, p_vs = int((p_got != p_plain).sum()), int((p_got != got).sum())
        log(f"[ground_pass_pose parity] {name}: B={BATCH} mismatched pixels {p_bad} against its "
            f"plain version, {p_vs} against ground_pass.cu")
        if p_bad or p_vs:
            raise AssertionError(f"pose-fed ground kernel check failed on {name}")
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
        d_got = RC.composite_depth_sky_cuda(rows, depth_rows, got, cam.width)
        d_plain = R.composite_plain(rows, depth_rows, got, cam.width, return_depth_sky=True)
        torch.cuda.synchronize()
        depth_sky_check(torch, name, d_got, d_plain, errs)
        if not torch.equal(d_got[0], c_got):
            raise AssertionError(f"the two composite modes' classes differ on {name}")
        inputs[name] = (win_cols, payload, rows, got, (starts, table, pose))
    # B=1, the collector's batch.
    one = _first(driven, 1)
    o_win, o_pay = R.prep_windows(one, params, cam)
    o_ground = RC.ground_pass_cuda(o_win, o_pay, slab, stripes, sky_px, hw, consts)
    o_rows = R.prep_candidates(one, params, cam)
    depth_sky_check(torch, "B=1", RC.composite_depth_sky_cuda(o_rows, depth_rows, o_ground, cam.width),
                    R.composite_plain(o_rows, depth_rows, o_ground, cam.width, return_depth_sky=True), errs)
    # N=128: all four mask words; the fourth must decide some pixels.
    _, _, rows_d, ground_d, _ = inputs["driven"]
    rows128 = torch.cat([rows_d, inputs["wrap"][2][:, :56]], 1).contiguous()
    c_plain = R.composite_plain(rows128, depth_rows, ground_d, cam.width)
    c_got = RC.composite_cuda(rows128, depth_rows, ground_d, cam.width)
    c_96 = R.composite_plain(rows128[:, :96].contiguous(), depth_rows, ground_d, cam.width)
    torch.cuda.synchronize()
    errs["composite"] = max(errs["composite"], int((c_got - c_plain).abs().max()))
    c_bad, decided = int((c_got != c_plain).sum()), int((c_plain != c_96).sum())
    log(f"[composite parity] N=128 candidates: B={BATCH} mismatched pixels {c_bad}, pixels decided "
        f"by candidates 96-127 {decided}, billboard pixels {int((c_got != ground_d).sum())}")
    if c_bad or not decided:
        raise AssertionError("composite kernel check failed on the N=128 batch")
    depth_sky_check(torch, "N=128 candidates",
                    RC.composite_depth_sky_cuda(rows128, depth_rows, ground_d, cam.width),
                    R.composite_plain(rows128, depth_rows, ground_d, cam.width, return_depth_sky=True),
                    errs)
    return params, gen, driven, errs, inputs["driven"]


def contracts_phase(torch, dev, params, gen, driven, errs):
    """The ground-pass kernel on the other contracts of the TPU package's
    ground kernels, 0 mismatched pixels against the plain version: the
    84x84 pixel-policy camera and the 180x320 / -15 deg chase camera
    (Pallas v4), a banked route batch (v3d; a bank of 64 random routes,
    capacity 1024, props, driven 64 steps), where the composite must also
    match and draw billboards, and B=1000 (v3c). Fills `errs`; returns
    (the route params, {row key: (label, windows, payload, slab, stripes,
    sky pixels, H*W)})."""
    from carla_ppo_tpu_torch.envs import route_env, route_planner
    from carla_ppo_tpu_torch.ops import rasterizer as R
    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC

    cam = R.CameraConfig()
    consts = R.style_constants(R.RoadStyle())
    bank = route_planner.make_route_bank(route_planner.make_town(seed=0), n_routes=64,
                                         capacity=1024, props=True, device=dev)
    route_params = route_env.route_env_params(bank)
    routed = route_env.reset(route_params, gen, batch=BATCH)
    for _ in range(64):
        act = torch.rand(BATCH, 2, generator=gen, device=dev)
        act[:, 0] = act[:, 0] * 0.4 - 0.2
        routed, _ = route_env.autoreset_step(routed, act, route_params, gen, obs_fn=None)
    contracts = {  # row: (label, states, params, camera)
        "v4_pixel_camera": ("84x84 camera", driven, params, R.CameraConfig(**PIXEL_CAMERA)),
        "v4_chase_camera": ("180x320 -15 deg chase camera", driven, params,
                            R.CameraConfig(**CHASE_CAMERA)),
        "v3d_banked": ("banked route batch", routed, route_params, cam),
        "v3c_odd_batch": (f"B={ODD_BATCH}", _first(driven, ODD_BATCH), params, cam),
    }
    inputs = {}
    for key, (label, states, prm, ccam) in contracts.items():
        c_slab, c_stripes, c_sky, c_depth = R._device_layout(ccam, str(dev))
        c_hw = ccam.height * ccam.width
        win_cols, payload = R.prep_windows(states, prm, ccam)
        plain = R.ground_pass_plain(win_cols, payload, c_slab, c_stripes, c_sky, c_hw, consts)
        got = RC.ground_pass_cuda(win_cols, payload, c_slab, c_stripes, c_sky, c_hw, consts)
        torch.cuda.synchronize()
        errs[key] = int((got - plain).abs().max())
        bad = int((got != plain).sum())
        log(f"[ground_pass parity] {label}: B={states.batch_size} {ccam.height}x{ccam.width} "
            f"mismatched pixels {bad} of {got.numel()}")
        if bad:
            raise AssertionError(f"ground-pass kernel disagrees with its plain version on {label}")
        if key == "v3d_banked":
            rows = R.prep_candidates(states, prm, ccam)
            c_plain = R.composite_plain(rows, c_depth, got, ccam.width)
            c_got = RC.composite_cuda(rows, c_depth, got, ccam.width)
            torch.cuda.synchronize()
            c_bad, drawn = int((c_got != c_plain).sum()), int((c_got != got).sum())
            log(f"[composite parity] {label}: B={BATCH} mismatched pixels {c_bad}, billboard pixels {drawn}")
            if c_bad or not drawn:
                raise AssertionError(f"composite kernel check failed on {label}")
        inputs[key] = (label, win_cols, payload, c_slab, c_stripes, c_sky, c_hw)
    return route_params, inputs


def kernel_times_phase(torch, smi, dev, driven_inputs, contract_inputs):
    """Each camera kernel's card ms (CUDA events, 50 launches) and its plain
    version's at the shapes of its kernels-line row (the driven batch, or
    the contract's inputs), and its least ms on an H100 by perfbench's
    yardstick: bytes over the HBM rate against the operations these inputs
    need over the FP32 or INT32 instruction rate (for the composite: its N
    x (W + H) coverage predicates, two float operations each, and one int32
    min per valid candidate and covered pixel, counted from the candidate
    rows; for the ground passes: dx * dx once per waypoint and run of
    pixels sharing a forward ray, four operations per pixel and waypoint,
    counted from the slab). Returns ({key: (kernel ms, plain ms)}, {key:
    (bound ms, what bounds it)})."""
    from carla_ppo_tpu_torch.ops import rasterizer as R
    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC
    from perfbench.harness import yardstick

    cam = R.CameraConfig()
    consts = R.style_constants(R.RoadStyle())
    slab, stripes, sky_px, depth_rows = R._device_layout(cam, str(dev))
    hw = cam.height * cam.width
    win_cols, payload, rows, ground, pose_in = driven_inputs
    g_ms = cuda_ms(torch, lambda: RC.ground_pass_cuda(win_cols, payload, slab, stripes, sky_px, hw, consts), 50)
    g_plain_ms = cuda_ms(torch, lambda: R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px, hw, consts), 3, 1)
    c_ms = cuda_ms(torch, lambda: RC.composite_cuda(rows, depth_rows, ground, cam.width), 50)
    c_plain_ms = cuda_ms(torch, lambda: R.composite_plain(rows, depth_rows, ground, cam.width), 3, 1)
    d_ms = cuda_ms(torch, lambda: RC.composite_depth_sky_cuda(rows, depth_rows, ground, cam.width), 50)
    d_plain_ms = cuda_ms(torch, lambda: R.composite_plain(rows, depth_rows, ground, cam.width,
                                                          return_depth_sky=True), 3, 1)
    p_ms = cuda_ms(torch, lambda: RC.ground_pass_pose_cuda(*pose_in, cam.window, slab, stripes, sky_px, hw, consts), 50)
    p_plain_ms = cuda_ms(torch, lambda: R.ground_pass_pose_plain(*pose_in, cam.window, slab, stripes, sky_px, hw, consts), 3, 1)
    g_bytes = 4 * (win_cols.numel() + payload.numel() + slab.numel() + stripes.numel() + BATCH * hw)
    c_bytes = 4 * (rows.numel() + depth_rows.numel() + 2 * BATCH * hw)
    # depth-and-sky: reads the ground (4 B a pixel), writes classes, depth
    # and sky (4 + 4 + 1 B)
    d_bytes = 4 * (rows.numel() + depth_rows.numel()) + 13 * BATCH * hw
    c_preds, c_mins = yardstick.composite_ops(rows, cam.height, cam.width)
    starts, table, pose = pose_in
    # The block reads its window's table rows once: window x 8 floats per env.
    p_bytes = 4 * (starts.numel() + BATCH * cam.window * 8 + pose.numel() + slab.numel()
                   + stripes.numel() + BATCH * hw)
    # ~24 float operations per window row to rotate it into the camera frame.
    p_ops = yardstick.ground_ops(BATCH, slab, stripes, 24 * cam.window)
    times = {"ground_pass": (g_ms, g_plain_ms), "composite": (c_ms, c_plain_ms),
             "ground_pass_pose": (p_ms, p_plain_ms), "composite_depth_sky": (d_ms, d_plain_ms)}
    bounds = {}
    fp32 = yardstick.FP32_OPS_PER_S
    composite_work = [(2 * c_preds, fp32), (c_mins, yardstick.INT32_OPS_PER_S)]
    for name, nbytes, work in (
            ("ground_pass", g_bytes, [(yardstick.ground_ops(BATCH, slab, stripes), fp32)]),
            ("composite", c_bytes, composite_work),
            ("composite_depth_sky", d_bytes, composite_work),
            ("ground_pass_pose", p_bytes, [(p_ops, fp32)])):
        bounds[name] = log_bound(name, nbytes, work)
    log(f"[timing] {smi}: ground_pass {g_ms:.6f} ms (plain {g_plain_ms:.3f} ms), "
        f"composite {c_ms:.6f} ms (plain {c_plain_ms:.3f} ms) at B={BATCH}")
    log(f"[timing] {smi}: ground_pass_pose {p_ms:.6f} ms (plain {p_plain_ms:.3f} ms) at B={BATCH}")
    log(f"[timing] {smi}: composite_depth_sky {d_ms:.6f} ms (plain {d_plain_ms:.3f} ms; bound "
        f"{bounds['composite_depth_sky'][0]:.6f} ms, share {bounds['composite_depth_sky'][0] / d_ms:.3f}) "
        f"beside the class-only composite {c_ms:.6f} ms at B={BATCH}")
    for key, (label, wc, pl, c_slab, c_stripes, c_sky, c_hw) in contract_inputs.items():
        B = wc.shape[0]
        k_ms = cuda_ms(torch, lambda: RC.ground_pass_cuda(wc, pl, c_slab, c_stripes, c_sky, c_hw, consts), 50)
        k_plain_ms = cuda_ms(torch, lambda: R.ground_pass_plain(wc, pl, c_slab, c_stripes, c_sky, c_hw, consts), 3, 1)
        k_bytes = 4 * (wc.numel() + pl.numel() + c_slab.numel() + c_stripes.numel() + B * c_hw)
        times[key] = (k_ms, k_plain_ms)
        bounds[key] = log_bound(f"ground_pass on {label}", k_bytes,
                                [(yardstick.ground_ops(B, c_slab, c_stripes), fp32)])
        log(f"[timing] {smi}: ground_pass on {label} {k_ms:.6f} ms "
            f"(plain {k_plain_ms:.3f} ms) at B={B}")
    return times, bounds


def drive_train(torch, ppo, RC, log_name, params, config, latent, model, gen, iterations,
                eval_gen, kernels=("ground_pass", "composite")):
    """Train `iterations` PPO iterations and run a greedy evaluate of
    EVAL_STEPS on one path with every launch count set to 0 first: losses,
    returns and eval metrics must be finite and the latent observation
    batch well formed; each of `kernels` must have launched, the VAE
    encode's kernels 3 times for each of the training rollouts' horizon + 1
    encodes, and no encode may have left them. Returns (eval metrics,
    launch counts)."""
    from carla_ppo_tpu_torch.ops import vae_cuda

    train_state = ppo.create_train_state(model, config, gen)
    envs = ppo.init_env_batch(params, config.num_envs, train_state.generator, config.env_kind)
    reset_launch_counts(RC)
    h0 = time.perf_counter()
    metrics = []
    for _ in range(iterations):
        train_state, envs, m = ppo.train_iteration(train_state, envs, params, config, latent_obs=latent)
        metrics.append(m)
    train_encode_launches = vae_cuda.LAUNCHES["vae_encode"]
    ev = ppo.evaluate(model, params, eval_gen, num_envs=config.num_envs, max_steps=EVAL_STEPS,
                      config=config, latent_obs=latent, chunk=EVAL_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - h0
    launches = launch_counts(RC)
    tag = "" if log_name == "lap" else f" {log_name}"
    for i, m in enumerate(metrics):
        vals = {k: m[k].item() for k in ("train_loss/loss", "train_loss/policy", "train_loss/value",
                                         "train/returns", "train/approx_kl", "train/reward")}
        log(f"[train{tag}] iteration {i}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items()))
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite training metrics on the {log_name} path: {bad}")
    obs = ppo.make_obs_fn(latent, config)(envs, params)
    if obs.shape != (config.num_envs, latent.obs_dim) or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"bad latent observation batch {tuple(obs.shape)} on the {log_name} path")
    ev_vals = {k: v.item() for k, v in ev.items() if v.ndim == 0}
    log(f"[eval{tag}] " + " ".join(f"{k}={v:.6g}" for k, v in ev_vals.items()))
    if not all(math.isfinite(v) for v in ev_vals.values()):
        raise AssertionError(f"non-finite eval metrics on the {log_name} path")
    log(f"[launches] {log_name} path ({iterations} iterations and the evaluate, {seconds:.1f} s): "
        f"{launches}; vae_encode in training {train_encode_launches}; encoder calls by path "
        f"{vae_cuda.CALLS}")
    if any(launches[k] <= 0 for k in kernels):
        raise AssertionError(f"a kernel of the {log_name} path never launched: {launches}")
    if train_encode_launches != 3 * (config.horizon + 1) * iterations or vae_cuda.CALLS["module"]:
        raise AssertionError(f"the {log_name} path's encodes did not all run the VAE encode kernels: "
                             f"{train_encode_launches} launches in training, {vae_cuda.CALLS}")
    return ev, launches


def ssm_phase(torch, smi, dev, params):
    """[ssm]: the memory policy's SSM step kernel (ssm_step.cu) against its
    plain twin (ops/ssm.py:ssm_step_plain) at the shape the
    granite-4.0-h-micro preset gives it, B=1024, H 64, P 64, N 128, with x,
    B and C views of one xBC row and every 7th env starting an episode,
    with and without commit: y within 1e-5 and the state within 1e-6 of
    the largest value (float32 rounding of the sum's order; the card test's
    tolerances), the state untouched without commit. Its time, the twin's
    and its bound (bytes: perfbench/harness/yardstick_seq.ssm_step_bytes).
    Then the preset's policy at its widths on 1024 lap envs with a seeded
    frozen seg VAE: a 3-step ppo.rollout with memory, the kernel's launch
    count set to 0 first, which must launch it once per Mamba layer (9) and
    policy step (4 with the bootstrap value), with finite outputs and the
    memory advanced. Returns (max |kernel - twin|, (kernel ms, twin ms),
    bound, the kernel's launches over the rollout)."""
    from carla_ppo_tpu_torch.models.hybrid_policy import HybridActorCritic
    from carla_ppo_tpu_torch.models.vae import VAE
    from carla_ppo_tpu_torch.ops import ssm, ssm_cuda
    from carla_ppo_tpu_torch.training import ppo
    from carla_ppo_tpu_torch.utils.device import make_generator
    from perfbench.harness import yardstick, yardstick_seq

    b, H, P, N = SSM_SHAPE
    g = make_generator(14, dev)
    xbc = torch.randn(b, H * P + 2 * N, generator=g, device=dev)
    x, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
    x = x.view(b, H, P)
    state = torch.randn(b, H, P, N, generator=g, device=dev)
    dt = torch.rand(b, H, generator=g, device=dev) * 0.1
    A = -torch.rand(H, generator=g, device=dev) * 15 - 1
    D = torch.randn(H, generator=g, device=dev)
    first = torch.arange(b, device=dev) % 7 == 0
    resets = int(first.sum())
    err = 0.0
    for commit in (True, False):
        want_state, got_state = state.clone(), state.clone()
        want = ssm.ssm_step_plain(want_state, x, dt, A, Bm, Cm, D, first, commit)
        got = ssm_cuda.ssm_step_cuda(got_state, x, dt, A, Bm, Cm, D, first, commit)
        torch.cuda.synchronize()
        y_err = float((got - want).abs().max())
        s_err = float((got_state - want_state).abs().max())
        y_tol = 1e-5 * max(1.0, float(want.abs().max()))
        s_tol = 1e-6 * max(1.0, float(want_state.abs().max()))
        untouched = commit or torch.equal(got_state, state)
        log(f"[ssm parity] commit={commit}: B={b} H={H} P={P} N={N}, {resets} envs reset: max |y - twin| "
            f"{y_err:.3e} (limit {y_tol:.3e}), max |state - twin| {s_err:.3e} (limit {s_tol:.3e})"
            + ("" if commit else f", state untouched {untouched}"))
        if y_err > y_tol or s_err > s_tol or not untouched:
            raise AssertionError(f"the SSM step kernel disagrees with its twin (commit={commit})")
        err = max(err, y_err, s_err)
        del want_state, got_state, want, got
    k_ms = cuda_ms(torch, lambda: ssm_cuda.ssm_step_cuda(state, x, dt, A, Bm, Cm, D, first), 50)
    plain_state = state.clone()
    plain_ms = cuda_ms(torch, lambda: ssm.ssm_step_plain(plain_state, x, dt, A, Bm, Cm, D, first), 3, 1)
    bnd = log_bound("ssm_step", yardstick_seq.ssm_step_bytes(b, H, P, N, resets, True),
                    [(5 * b * H * P * N, yardstick.FP32_OPS_PER_S)])
    log(f"[timing] {smi}: ssm_step {k_ms:.6f} ms (plain {plain_ms:.3f} ms; bound {bnd[0]:.6f} ms, share "
        f"{bnd[0] / k_ms:.3f}) at B={b}, H {H}, P {P}, N {N}")
    del xbc, x, Bm, Cm, state, plain_state
    torch.cuda.empty_cache()

    vae = VAE(source_shape=(80, 160, 1), z_dim=64, generator=make_generator(1, "cpu")).to(dev).eval()
    latent = ppo.LatentObs(vae_model=vae)
    model = HybridActorCritic(latent.obs_dim, "granite-4.0-h-micro", generator=make_generator(15, dev), device=dev)
    gen = make_generator(16, dev)
    envs = ppo.init_env_batch(params, b, gen)
    memory = model.initial_memory(b)
    torch.cuda.synchronize()
    ssm_cuda.LAUNCHES["ssm_step"] = 0
    t0 = time.perf_counter()
    _, traj, boot, _ = ppo.rollout(model, envs, params, gen, SSM_ROLLOUT_STEPS, ppo.PPOConfig(),
                                   latent_obs=latent, memory=memory)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ssm_cuda.LAUNCHES["ssm_step"]
    per_step = model.sizes.n_mamba
    finite = all(bool(torch.isfinite(t).all()) for t in (traj.actions, traj.log_probs, traj.values, boot, memory.ssm))
    advanced = not bool(memory.ssm.eq(0).all()) and memory.slot == SSM_ROLLOUT_STEPS
    log(f"[ssm] {smi}: granite-4.0-h-micro policy, {sum(q.numel() for q in model.parameters())} parameters, "
        f"{b} envs: a {SSM_ROLLOUT_STEPS}-step rollout in {wall:.3f} s (the first calls included), "
        f"ssm_step launches {launches} ({per_step} a policy step x {SSM_ROLLOUT_STEPS + 1} steps with the "
        f"bootstrap), finite {finite}, memory advanced {advanced}, card memory peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if launches != per_step * (SSM_ROLLOUT_STEPS + 1) or per_step != 9 or not finite or not advanced:
        raise AssertionError("the memory policy's rollout did not step its memory through the SSM kernel")
    del vae, latent, model, envs, memory, traj, boot
    torch.cuda.empty_cache()
    return err, (k_ms, plain_ms), bnd, launches


def vae_phase(torch, smi, dev):
    """[vae]: the frozen VAE encode's kernels (vae_encode.cu) at B=1024 on
    the converted de-prop seg VAE (1 channel, frames with ~30% of pixels
    set) and the converted rgb->de-prop VAE (3 channels, uniform frames):
    VAE.encode (the kernels and the mean head) within 1e-5 of max |z| of
    the plain twin (ops/vae_cuda.py:encoder_plain, cuDNN in float32, TF32
    off) and the head, two calls bit-identical, 3 launches an encode. The
    seg encode's card ms beside its bound (the encoder's and the mean
    head's float operations, perfbench/harness/yardstick.py's count, at 67
    TFLOP/s) and the cuDNN path's ms (the row's plain ms and `library_ms`).
    Returns (max |z - twin's z| over both VAEs, (seg encode ms, the twin's
    ms), bound)."""
    from carla_ppo_tpu_torch.models import vae_common
    from carla_ppo_tpu_torch.ops import vae_cuda
    from perfbench.harness import yardstick

    g = torch.Generator(device=dev).manual_seed(18)
    errs = []
    for label, path, cin in (("seg", DEPROP_VAE, 1), ("rgb", RGB_DEPROP_VAE, 3)):
        vae = vae_common.load_vae(path, device=dev)
        x = torch.rand(VAE_BATCH, 80, 160, cin, generator=g, device=dev)
        if cin == 1:
            x = (x < 0.3).float()  # ~30% of the pixels set, as a segmentation mask
        with torch.no_grad():
            want = vae.mean_head(vae_cuda.encoder_plain(x, vae.encoder.convs))
            launches = vae_cuda.LAUNCHES["vae_encode"]
            got = vae.encode(x)
            torch.cuda.synchronize()
            launches = vae_cuda.LAUNCHES["vae_encode"] - launches
            same = torch.equal(got, vae.encode(x))
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        errs.append(err)
        log(f"[vae parity] {label} VAE ({cin} channel{'s' if cin > 1 else ''}), B={VAE_BATCH}: max |z - twin| "
            f"{err:.3e} (limit {tol:.3e}), repeat bit-identical {same}, launches an encode {launches}")
        if err > tol or not same or launches != 3:
            raise AssertionError(f"the VAE encode kernels disagree with their plain twin on the {label} VAE")
        if cin == 1:
            seg, seg_x = vae, x
    with torch.no_grad():
        k_ms = cuda_ms(torch, lambda: seg.encode(seg_x), 20)
        lib_ms = cuda_ms(torch, lambda: seg.mean_head(vae_cuda.encoder_plain(seg_x, seg.encoder.convs)), 20)
    enc, flat = yardstick._encoder_flops(80, 160, 1, vae_cuda.FEATURES)
    flops = VAE_BATCH * (enc + 2 * flat * seg.z_dim)
    # bytes: the frames, conv2's and conv3's outputs written and read once, the weights
    nbytes = 4 * (seg_x.numel() + 2 * VAE_BATCH * (18 * 38 * 64 + 8 * 18 * 128)
                  + sum(q.numel() for q in seg.encoder.parameters()) + VAE_BATCH * seg.z_dim)
    bnd = log_bound("vae_encode", nbytes, [(flops / 2, yardstick.FP32_OPS_PER_S)])
    log(f"[timing] {smi}: vae_encode {k_ms:.6f} ms (bound {bnd[0]:.6f} ms, share {bnd[0] / k_ms:.3f}; "
        f"library_ms: the cuDNN path {lib_ms:.6f} ms) at B={VAE_BATCH}, seg VAE")
    del vae, seg, x, seg_x, want, got
    torch.cuda.empty_cache()
    return max(errs), (k_ms, lib_ms), bnd


def paths_phase(torch, RC, dev, params, route_params):
    """Latent PPO through drive_train on four paths, each 1024 envs:
    - lap: PPOConfig defaults (horizon 128, 3 epochs x 4 minibatches) with
      a seeded frozen ConvVAE (the de-prop seg VAE's widths: 1 channel, z
      64, 32/64/128/256) and a seeded 500/300 ActorCritic, 2 iterations;
    - rgb: the lap path with RGB latents (LatentObs(source="rgb")) through
      the converted rgb->de-prop VAE (3-channel source), 2 iterations; the
      ground pass and the depth-and-sky composite must launch;
    - route: PPOConfig(env_kind="route", normalize_rewards=True) on
      contracts_phase's bank of 64 random routes, 2 iterations;
    - lap_bank: 16 lap circuits (capacity 2048, props), 1 iteration; its
      evaluate must report finite eval/laps_per_track for each of the 16
      tracks.
    Returns {path: launch counts}."""
    from carla_ppo_tpu_torch.envs import lap_bank_env
    from carla_ppo_tpu_torch.models import vae_common
    from carla_ppo_tpu_torch.models.policy import ActorCritic
    from carla_ppo_tpu_torch.training import ppo
    from carla_ppo_tpu_torch.utils.device import make_generator

    _, latent, model, config = _lap_latent_setup(torch, dev)
    launches = {}
    _, launches["lap"] = drive_train(torch, ppo, RC, "lap", params, config, latent, model,
                                     make_generator(2, dev), 2, make_generator(3, dev))

    rgb_latent = ppo.LatentObs(vae_model=vae_common.load_vae(RGB_DEPROP_VAE, device=dev), source="rgb")
    rgb_model = ActorCritic(rgb_latent.obs_dim, generator=make_generator(10, "cpu")).to(dev)
    _, launches["rgb"] = drive_train(torch, ppo, RC, "rgb", params, config, rgb_latent, rgb_model,
                                     make_generator(11, dev), 2, make_generator(12, dev),
                                     kernels=("ground_pass", "composite_depth_sky"))

    route_config = ppo.PPOConfig(env_kind="route", normalize_rewards=True)
    seed_gen = make_generator(4, "cpu")
    route_model = ActorCritic(latent.obs_dim, generator=seed_gen).to(dev)
    _, launches["route"] = drive_train(torch, ppo, RC, "route", route_params, route_config, latent,
                                       route_model, make_generator(5, dev), 2, make_generator(6, dev))

    lap_bank = lap_bank_env.make_lap_bank(n_tracks=16, capacity=2048, props=True, device=dev)
    bank_params = lap_bank_env.lap_bank_params(lap_bank)
    bank_config = ppo.PPOConfig(env_kind="lap_bank")
    bank_model = ActorCritic(latent.obs_dim, generator=seed_gen).to(dev)
    bank_ev, launches["lap_bank"] = drive_train(torch, ppo, RC, "lap_bank", bank_params, bank_config,
                                                latent, bank_model, make_generator(7, dev), 1,
                                                make_generator(8, dev))
    per_track = bank_ev["eval/laps_per_track"]
    log(f"[eval lap_bank] eval/laps_per_track ({per_track.numel()} tracks): "
        + " ".join(f"{v:.6g}" for v in per_track.tolist()))
    if per_track.shape != (16,) or not bool(torch.isfinite(per_track).all()):
        raise AssertionError(f"bad eval/laps_per_track {tuple(per_track.shape)}")
    return launches


def entry_phase(torch, RC, dev, params, driven):
    """The camera's other entry points, each driven over ENTRY_STEPS lap
    steps with every frame rendered through it, from launch counts of 0:
    render_batch_pose (the pose-fed camera), render_batch with the 84x84
    camera (v4) and render_batch at B=1000 (v3c). Each must launch its
    kernel and give class ids in 0-12. Returns {row key: launches}."""
    from carla_ppo_tpu_torch.envs import lap_env
    from carla_ppo_tpu_torch.ops import rasterizer as R
    from carla_ppo_tpu_torch.utils.device import make_generator

    cam, style = R.CameraConfig(), R.RoadStyle()

    def drive(label, states, render, counter):
        g = make_generator(9, dev)
        RC.reset_launch_counts()
        for _ in range(ENTRY_STEPS):
            frames = render(states)
            a = torch.rand(states.batch_size, 2, generator=g, device=dev)
            a[:, 0] = a[:, 0] * 0.6 - 0.3
            states, _ = lap_env.autoreset_step(states, a, params, g, obs_fn=None)
        torch.cuda.synchronize()
        launches = dict(RC.LAUNCHES)
        log(f"[launches] {label} path ({ENTRY_STEPS} lap steps, frames {tuple(frames.shape)}): {launches}")
        if launches[counter] <= 0 or not bool(((frames >= 0) & (frames <= 12)).all()):
            raise AssertionError(f"the {label} path did not render through {counter}: {launches}")
        return launches[counter]

    return {
        "ground_pass_pose": drive("render_batch_pose", driven,
                                  lambda s: R.render_batch_pose(s, params, cam, style), "ground_pass_pose"),
        "v4": drive("84x84-camera render_batch", driven,
                    lambda s: R.render_batch(s, params, R.CameraConfig(**PIXEL_CAMERA), style), "ground_pass"),
        "v3c": drive(f"B={ODD_BATCH} render_batch", _first(driven, ODD_BATCH),
                     lambda s: R.render_batch(s, params, cam, style), "ground_pass"),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC
    from carla_ppo_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    # 2. The build.
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load_library()
    log(f"[build] {lib_path} ready in {time.perf_counter() - t0:.2f} s ({len(cuda_build.SOURCES)} sources)")

    params, gen, driven, errs, driven_inputs = camera_parity_phase(torch, dev)
    route_params, contract_inputs = contracts_phase(torch, dev, params, gen, driven, errs)
    times, bounds = kernel_times_phase(torch, smi, dev, driven_inputs, contract_inputs)
    del driven_inputs, contract_inputs
    errs["ssm_step"], times["ssm_step"], bounds["ssm_step"], ssm_launches = ssm_phase(torch, smi, dev, params)
    errs["vae_encode"], times["vae_encode"], bounds["vae_encode"] = vae_phase(torch, smi, dev)
    paths = paths_phase(torch, RC, dev, params, route_params)
    entry_launches = entry_phase(torch, RC, dev, params, driven)
    trainer_launches = trainer_phase(torch, RC)
    pretrained_launches = eval_phase(RC, smi, "pretrained", LATENT_AGENT, ["--vae_model", DEPROP_VAE],
                                     PRETRAINED_ENVS, PRETRAINED_STEPS, 0.05,
                                     ("ground_pass", "composite"))
    rgb_eval_launches = eval_phase(RC, smi, "rgb_pretrained", RGB_AGENT,
                                   ["--vae_model", RGB_DEPROP_VAE, "--vae_source", "rgb"],
                                   PRETRAINED_ENVS, PRETRAINED_STEPS, 0.05,
                                   ("ground_pass", "composite_depth_sky"))
    traffic_launches = eval_phase(RC, smi, "traffic", TRAFFIC_AGENT, TRAFFIC_ARGV, TRAFFIC_ENVS,
                                  TRAFFIC_STEPS, 0.10, (), require_finished_or_running=False,
                                  require_overtakes=True)
    vae_launches = vae_pipeline_phase(torch, RC, driven, params)
    pixel_launches = pixel_phase(torch, RC, smi)
    pixel_eval_launches = eval_phase(RC, smi, "pixel_pretrained", PIXEL_AGENT, ["--obs", "pixels"],
                                     PRETRAINED_ENVS, PRETRAINED_STEPS, 0.05,
                                     ("ground_pass", "composite"))
    dp_launches = dp_phase(torch, smi)
    agents_launches = agents_phase(torch, RC, smi, dev)
    video_launches, video_contracts, b1_ms = video_phase(torch, RC, smi, dev)
    inspect_phase(torch, smi, dev, _first(driven, INSPECT_FRAMES), params)

    # The kernels line: one row per TPU kernel.
    def row(name, source, replaces, launches, key, err):
        return {"name": name, "route": "cuda", "source": f"{CSRC}/{source}",
                "replaces": f"{PALLAS}:{replaces}", "launches": launches, "max_abs_err": err,
                "ms": times[key][0], "plain_ms": times[key][1], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": None,
                "bound_share": bounds[key][0] / times[key][0]}

    # Pallas v4, v3d and v3c compute v5's function under other TPU layouts;
    # their rows hold ground_pass.cu on each one's contract and path.
    kernels = [
        row("ground_pass", "ground_pass.cu", 698, paths["lap"]["ground_pass"], "ground_pass",
            errs["ground_pass"]),
        row("composite", "composite.cu", 1290, paths["lap"]["composite"], "composite",
            errs["composite"]),
        row("ground_pass (v4 contract: 84x84 camera)", "ground_pass.cu", 539, entry_launches["v4"],
            "v4_pixel_camera", max(errs["v4_pixel_camera"], errs["v4_chase_camera"])),
        row("ground_pass (v3d contract: banked route batch)", "ground_pass.cu", 1014,
            paths["route"]["ground_pass"], "v3d_banked", errs["v3d_banked"]),
        row(f"ground_pass (v3c contract: B={ODD_BATCH})", "ground_pass.cu", 186, entry_launches["v3c"],
            "v3c_odd_batch", errs["v3c_odd_batch"]),
        row("ground_pass_pose", "ground_pass_pose.cu", 955, entry_launches["ground_pass_pose"],
            "ground_pass_pose", errs["ground_pass_pose"]),
        # The composite's depth-and-sky mode: on the TPU's RGB path the XLA
        # _composite_billboards_flat(..., return_depth_sky=True) computes it
        # (the Pallas composite it extends is class-only).
        row("composite (depth-and-sky mode)", "composite.cu", 1290,
            paths["rgb"]["composite_depth_sky"], "composite_depth_sky", errs["composite_depth_sky"]),
        # The memory policy's SSM step: no TPU kernel (the JAX package has
        # no recurrent policy); its launches are the [ssm] rollout's.
        {**row("ssm_step", "ssm_step.cu", None, ssm_launches, "ssm_step", errs["ssm_step"]), "replaces": None},
        # The frozen VAE encode: no TPU kernel (XLA ran the convolutions);
        # its plain version is the twin on the card, cuDNN, as library_ms;
        # its launches are the lap path's (3 an encode, 129 encodes an
        # iteration, and the evaluate's).
        {**row("vae_encode", "vae_encode.cu", None, paths["lap"]["vae_encode"], "vae_encode",
               errs["vae_encode"]), "replaces": None, "library_ms": times["vae_encode"][1]},
    ]
    for k in kernels[:2]:
        k["phase_launches"] = {**{f"dp rank {r}": n[k["name"]] for r, n in enumerate(dp_launches)},
                               "agents": agents_launches[k["name"]], "video": video_launches[k["name"]]}
    # [video] launches of ground_pass.cu by contract (they sum to the
    # phase's): the chase camera of a shared track (v4), every frame of
    # the route episode (v3d, banked), B=1 dashcam frames of a shared
    # track (v3c).
    for k, contract in ((2, "v4"), (3, "v3d"), (4, "v3c")):
        kernels[k]["phase_launches"] = {"video": video_contracts[contract]}
    kernels[6]["phase_launches"] = {"video": video_launches["composite_depth_sky"]}
    kernels[8]["phase_launches"] = {
        "rgb": paths["rgb"]["vae_encode"], "route": paths["route"]["vae_encode"],
        "lap_bank": paths["lap_bank"]["vae_encode"], "trainer": trainer_launches["vae_encode"],
        "pretrained": pretrained_launches["vae_encode"], "rgb_pretrained": rgb_eval_launches["vae_encode"],
        "vae_pipeline": vae_launches["vae_encode"], "pixels": pixel_launches["vae_encode"],
        "pixel_pretrained": pixel_eval_launches["vae_encode"],
        **{f"dp rank {r}": n["vae_encode"] for r, n in enumerate(dp_launches)}}
    # ... and each contract's time at B=1.
    for k, key in ((1, "composite 80x160"), (2, "ground_pass 180x320"),
                   (3, "ground_pass banked 80x160"), (4, "ground_pass 80x160"),
                   (6, "composite_depth_sky 80x160")):
        kernels[k]["b1_ms"] = b1_ms[key]
    log(f"[launches] lap_bank path: ground_pass {paths['lap_bank']['ground_pass']}, "
        f"composite {paths['lap_bank']['composite']}")
    log(f"[launches] trainer path: {trainer_launches}; pretrained path: {pretrained_launches}; "
        f"rgb_pretrained path: {rgb_eval_launches}; traffic path: {traffic_launches}; "
        f"vae_pipeline path: {vae_launches}; pixels path: {pixel_launches}; pixel_pretrained "
        f"path: {pixel_eval_launches}; video phase: {video_launches}")
    log(json.dumps({"kernels": kernels}))
    missed = [path for path, n in kernels[8]["phase_launches"].items() if n <= 0]
    if missed:
        raise AssertionError(f"paths that never launched the VAE encode kernels: {missed}")
    over = [(k["name"], k["bound_share"]) for k in kernels if k["bound_share"] > 1.05]
    if over:
        raise AssertionError(f"a kernel ran faster than its bound allows: {over}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def _state_checksum(torch, train_state) -> str:
    """sha256 of every parameter, buffer, Adam moment and reward moment."""
    import hashlib

    from carla_ppo_tpu_torch.parallel import train_dp

    h = hashlib.sha256()
    for t in train_dp._state_tensors(train_state):
        h.update(t.detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _lap_latent_setup(torch, dev):
    """(lap params, LatentObs, ActorCritic, PPOConfig) of the lap path: the lap
    track with props, the seeded de-prop seg VAE widths, a 500/300 policy
    (weights made on the host from seed 1, then moved)."""
    from carla_ppo_tpu_torch.envs import track
    from carla_ppo_tpu_torch.envs.types import EnvParams
    from carla_ppo_tpu_torch.models.policy import ActorCritic
    from carla_ppo_tpu_torch.models.vae import VAE
    from carla_ppo_tpu_torch.training import ppo
    from carla_ppo_tpu_torch.utils.device import make_generator

    params = EnvParams(track=track.make_lap_track(seed=0, props=True, device=dev))
    seed_gen = make_generator(1, "cpu")
    vae = VAE(source_shape=(80, 160, 1), z_dim=64, generator=seed_gen).to(dev).eval()
    latent = ppo.LatentObs(vae_model=vae)
    model = ActorCritic(latent.obs_dim, generator=seed_gen).to(dev)
    return params, latent, model, ppo.PPOConfig()


def dp_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One rank of [dp] (a spawned process): DP_ITERATIONS data-parallel
    iterations and a DP evaluate on its slice of 1024 envs; writes what it
    saw to out_dir/rank<rank>.json."""
    import torch

    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC
    from carla_ppo_tpu_torch.parallel import mesh, train_dp
    from carla_ppo_tpu_torch.training import ppo
    from carla_ppo_tpu_torch.utils.device import exact_float32, make_generator

    exact_float32()
    dp = mesh.init(rank, world, init_method, "cuda", backend="gloo", timeout_s=DP_DEADLINE_S / 2)
    try:
        dev = dp.device
        params, latent, model, config = _lap_latent_setup(torch, dev)
        ts = ppo.create_train_state(model, config, make_generator(2, dev))
        envs = train_dp.shard_env_batch(ppo.init_env_batch(params, config.num_envs, ts.generator), dp)
        train_dp.replicate(ts, dp)
        step = train_dp.make_dp_train_iteration(dp, config, params, latent)
        out = {"iterations": []}
        for _ in range(DP_ITERATIONS):
            reset_launch_counts(RC)
            ts, envs, m = step(ts, envs)
            torch.cuda.synchronize()
            out["iterations"].append({
                "launches": launch_counts(RC), "checksum": _state_checksum(torch, ts),
                "metrics": {k: m[k].item() for k in ("train_loss/loss", "train_loss/policy",
                                                     "train_loss/value", "train/returns",
                                                     "train/approx_kl")},
                "total_env_steps": ts.total_env_steps})
        reset_launch_counts(RC)
        ev = train_dp.make_dp_evaluate(dp, ts.model, config, params, config.num_envs, chunk=EVAL_STEPS,
                                       latent_obs=latent)(make_generator(3, dev), EVAL_STEPS)
        torch.cuda.synchronize()
        out["eval"] = {"launches": launch_counts(RC), "metrics": {k: v.tolist() for k, v in ev.items()}}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        mesh.destroy()


def dp_phase(torch, smi):
    """[dp]: data-parallel latent lap PPO over DP_WORLD ranks on the one card
    (spawned processes, gloo with CUDA tensors: NCCL refuses two ranks on
    one device), 1024 envs (512 a rank), PPOConfig defaults, the seeded
    de-prop seg VAE widths and a 500/300 policy: DP_ITERATIONS iterations,
    then a 300-step DP evaluate of 1024 envs. After each iteration the
    ranks' checksums of every parameter, buffer, Adam moment and reward
    moment must be equal; each rank's rollout must launch the ground pass
    and the composite 129 times and the VAE encode 3 x 129, with finite
    losses and the global batch's env-step count; the ranks' evaluate
    metrics must be equal and finite. Two ranks on one card check
    correctness, not scaling. Then one iteration at world size 1 over NCCL
    (the multi-card Trainer's backend) against a single-device
    train_iteration from the same state and streams: parameters within
    1e-4 and each step within 2% of the learning rate
    (tests/test_torch_ppo.py::test_update_phase_matches). Returns each
    rank's launches over its last training iteration."""
    import torch.multiprocessing as mp

    from carla_ppo_tpu_torch.envs.types import map_tensors
    from carla_ppo_tpu_torch.parallel import mesh, train_dp
    from carla_ppo_tpu_torch.training import ppo
    from carla_ppo_tpu_torch.utils.device import make_generator

    config = ppo.PPOConfig()
    with tempfile.TemporaryDirectory() as out_dir:
        h0 = time.perf_counter()
        ctx = mp.start_processes(dp_rank, args=(DP_WORLD, f"tcp://127.0.0.1:{mesh.free_port()}", out_dir),
                                 nprocs=DP_WORLD, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(1.0, DP_DEADLINE_S - (time.perf_counter() - h0))):
                if time.perf_counter() - h0 > DP_DEADLINE_S:
                    raise AssertionError(f"[dp] ranks still running after {DP_DEADLINE_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        wall = time.perf_counter() - h0
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    per_rank = config.num_envs // DP_WORLD
    for i in range(DP_ITERATIONS):
        its = [rk["iterations"][i] for rk in ranks]
        sums = [it["checksum"] for it in its]
        steps = config.horizon * config.num_envs
        log(f"[dp] iteration {i}, {DP_WORLD} ranks x {per_rank} envs on one card (gloo): state checksums "
            f"{[c[:16] for c in sums]}; launches {[it['launches'] for it in its]}; metrics {its[0]['metrics']}")
        if len(set(sums)) != 1:
            raise AssertionError(f"[dp] the ranks' states differ after iteration {i}: {sums}")
        for r, it in enumerate(its):
            if (it["launches"]["ground_pass"], it["launches"]["composite"], it["launches"]["vae_encode"]) \
                    != (config.horizon + 1, config.horizon + 1, 3 * (config.horizon + 1)):
                raise AssertionError(f"[dp] rank {r} rollout {i} launched {it['launches']}, not "
                                     f"{config.horizon + 1} of each camera kernel")
            if not all(math.isfinite(v) for v in it["metrics"].values()):
                raise AssertionError(f"[dp] non-finite metrics on rank {r}: {it['metrics']}")
            if it["total_env_steps"] != (i + 1) * steps:
                raise AssertionError(f"[dp] total_env_steps {it['total_env_steps']} is not the global batch's")
    evs = [rk["eval"] for rk in ranks]
    log(f"[dp] DP evaluate {EVAL_STEPS} steps x {config.num_envs} envs: launches "
        f"{[e['launches'] for e in evs]}; "
        + " ".join(f"{k}={v:.6g}" for k, v in evs[0]["metrics"].items() if isinstance(v, float)))
    if evs[0]["metrics"] != evs[1]["metrics"]:
        raise AssertionError("[dp] the ranks' evaluate metrics differ")
    if not all(math.isfinite(v) for v in evs[0]["metrics"].values() if isinstance(v, float)):
        raise AssertionError(f"[dp] non-finite eval metrics: {evs[0]['metrics']}")
    log(f"[dp] {smi}: the phase's two ranks took {wall:.2f} s with process start-up")

    # World size 1 over NCCL against the single-device iteration.
    dev = torch.device("cuda")
    dp = mesh.init(0, 1, f"tcp://127.0.0.1:{mesh.free_port()}", "cuda", timeout_s=300)
    try:
        params, latent, model, config = _lap_latent_setup(torch, dev)
        ts = ppo.create_train_state(model, config, make_generator(4, dev))
        envs = ppo.init_env_batch(params, config.num_envs, ts.generator)
        train_dp.replicate(ts, dp)
        single = ts.restored(ts.checkpoint_tree())  # a copy: the update makes new tensors
        single_envs = map_tensors(lambda t: t.clone(), envs)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        train_dp.make_dp_train_iteration(dp, config, params, latent)(ts, envs)
        ppo.train_iteration(single, single_envs, params, config, latent_obs=latent)
        torch.cuda.synchronize()
        got = dict(ts.model.named_parameters())
        want = dict(single.model.named_parameters())
        p_err = max(float((got[n] - want[n]).detach().abs().max()) for n in got)
        s_err = max(float(((got[n] - before[n]) - (want[n] - before[n])).detach().abs().max())
                    for n in got)
        log(f"[dp] {smi}: world size 1 over {dp.backend} vs the single-device train_iteration, "
            f"{config.num_envs} envs: "
            f"max |param diff| {p_err:.3g} (bound 1e-4), max |step diff| {s_err:.3g} (bound "
            f"{0.02 * config.learning_rate:.3g})")
        if p_err > 1e-4 or s_err > 0.02 * config.learning_rate:
            raise AssertionError("[dp] world size 1 disagrees with the single-device iteration")
    finally:
        mesh.destroy()
    return [rk["iterations"][-1]["launches"] for rk in ranks]


def agents_phase(torch, RC, smi, dev):
    """[agents]: a fleet of 1024 roaming agents (envs/agents.py, 18 km/h) on
    the lap track with props and traffic lights (add_traffic_lights), no
    NPCs, 1200 lap_env steps (40 s) from resets spread over the lap, the seg
    camera rendered through the kernels every 10th step: no episode may end
    for another reason than VEHICLE_STOPPED while waiting at a red light (in
    particular no OFF_TRACK), mean distance above 150 m, centre deviation
    below 1.6 m, and 8-25 km/h average speed over the agents that never
    stood at a red light (the JAX package's tests/test_agents.py contract at
    fleet size). Then a batch spawned before each light: the kernel frame
    equals the plain frame with the light's TRAFFICSIGNS pole in it, an
    always-red table stops every agent short of its light within 600 steps,
    an always-green one lets every agent pass
    (tests/test_traffic_lights.py's contracts). Returns the camera launches
    of the fleet's drive."""
    from carla_ppo_tpu_torch.envs import agents, lap_env, track
    from carla_ppo_tpu_torch.envs import traffic_lights as TL
    from carla_ppo_tpu_torch.envs.types import EnvParams, SegClass, TerminationReason
    from carla_ppo_tpu_torch.ops import rasterizer as R
    from carla_ppo_tpu_torch.utils.device import make_generator

    fleet = BATCH
    params = TL.add_traffic_lights(EnvParams(track=track.make_lap_track(seed=0, props=True, device=dev)))
    L, lights = params.track.length, params.light_wp
    wait_steps = int(round(params.reward.low_speed_timeout / params.dt))
    gen = make_generator(0, dev)
    states = lap_env.reset(params, gen, checkpoint_idx=torch.arange(fleet, device=dev) * L // fleet)
    agent = agents.AgentState.create(fleet, dev, AGENT_SPEED_KMH)
    cam = R.CameraConfig()
    last_red = torch.full((fleet,), -10**9, dtype=torch.int64, device=dev)
    stood_at_red = torch.zeros(fleet, dtype=torch.bool, device=dev)
    bad_ends = torch.zeros(fleet, dtype=torch.int64, device=dev)
    red_stops = torch.zeros(fleet, dtype=torch.int64, device=dev)
    max_dev = torch.zeros(fleet, device=dev)
    RC.reset_launch_counts()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for i in range(AGENT_STEPS):
        if i % AGENT_RENDER_EVERY == 0:
            frames = R.render_batch(states, params, cam)
        red = TL.is_red_light_ahead(states, params)
        last_red = torch.where(red, i, last_red)
        stood_at_red |= red & (states.vehicle.vx < 0.6)
        action, agent = agents.roaming_agent_step(agent, states, params)
        states, out = lap_env.step(states, action, params, obs_fn=None)
        waited = (out.termination_reason == int(TerminationReason.VEHICLE_STOPPED)) & (
            i - last_red <= wait_steps)
        red_stops += (out.done & waited).long()
        bad_ends += (out.done & ~waited).long()
        max_dev = torch.maximum(max_dev, states.distance_from_center)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - h0
    launches = dict(RC.LAUNCHES)
    dist = states.distance_traveled
    speed = 3.6 * states.speed_accum / states.step_count.clamp(min=1)
    moving = ~stood_at_red
    log(f"[agents] {smi}: {fleet} roaming agents, {params.light_wp.numel()} lights at waypoints "
        f"{lights.tolist()}, {AGENT_STEPS} steps in {seconds:.3f} s (a seg frame every "
        f"{AGENT_RENDER_EVERY} steps); mean distance "
        f"{float(dist.mean()):.3f} m (min {float(dist.min()):.3f}), max centre deviation "
        f"{float(max_dev.max()):.4f} m, {int(stood_at_red.sum())} agents stood at a red light, "
        f"{int(red_stops.sum())} VEHICLE_STOPPED ends while waiting at one, {int(bad_ends.sum())} "
        f"other ends; average speed of the others {float(speed[moving].min()):.3f}-"
        f"{float(speed[moving].max()):.3f} km/h; frames {tuple(frames.shape)}; launches {launches}")
    if int(bad_ends.sum()):
        raise AssertionError(f"[agents] {int(bad_ends.sum())} episodes ended for another reason than "
                             "waiting at a red light")
    if not float(dist.mean()) > 150.0 or not float(max_dev.max()) < 1.6:
        raise AssertionError("[agents] the fleet fell short of 150 m or left its lane by 1.6 m")
    if not bool(moving.any()) or not (8.0 < float(speed[moving].min()) and float(speed[moving].max()) < 25.0):
        raise AssertionError("[agents] average speeds outside 8-25 km/h")
    if launches["ground_pass"] != AGENT_STEPS // AGENT_RENDER_EVERY or launches["composite"] <= 0:
        raise AssertionError(f"[agents] the fleet's camera did not run through the kernels: {launches}")

    # The lights: a batch spawned LIGHT_SPAWN_BEFORE waypoints before each.
    start = (lights.to(torch.int64) - LIGHT_SPAWN_BEFORE) % L
    spawn = lap_env.reset(params, gen, checkpoint_idx=start.to(torch.int32))
    bare = EnvParams(track=track.make_lap_track(seed=0, props=True, device=dev))
    win_cols, payload = R.prep_windows(spawn, params, cam)
    slab, stripes, sky_px, depth_rows = R._device_layout(cam, str(dev))
    plain = R.composite_plain(R.prep_candidates(spawn, params, cam), depth_rows,
                              R.ground_pass_plain(win_cols, payload, slab, stripes, sky_px,
                                                  cam.height * cam.width,
                                                  R.style_constants(R.RoadStyle())), cam.width)
    got = R.render_batch(spawn, params, cam).reshape(plain.shape)
    signs = int(SegClass.TRAFFICSIGNS)
    n_signs = (got == signs).sum(1)
    n_bare = (R.render_batch(spawn, bare, cam).reshape(plain.shape) == signs).sum(1)
    mismatched = int((got != plain).sum())
    log(f"[agents] light frames: B={spawn.batch_size}, {LIGHT_SPAWN_BEFORE} m before each light: "
        f"mismatched pixels {mismatched} against the plain frame; TRAFFICSIGNS pixels {n_signs.tolist()} "
        f"(without the light poles {n_bare.tolist()})")
    if mismatched or not bool((n_signs > 3).all()) or not bool((n_signs > n_bare).all()):
        raise AssertionError("[agents] a light's frame disagrees or shows no pole")
    target = spawn.waypoint_idx + LIGHT_SPAWN_BEFORE
    for label, green, yellow in (("always red", 0.0, 0.0), ("always green", 1.0, 0.0)):
        p = dataclasses.replace(params, light_green_frac=green, light_yellow_frac=yellow)
        s = spawn
        a = agents.AgentState.create(s.batch_size, dev, AGENT_SPEED_KMH)
        for _ in range(LIGHT_STEPS):
            act, a = agents.roaming_agent_step(a, s, p)
            s, _ = lap_env.step(s, act, p, obs_fn=None)
        log(f"[agents] {label}: after {LIGHT_STEPS} steps waypoints {(s.waypoint_idx - target).tolist()} "
            f"from each light, vx {[round(v, 3) for v in s.vehicle.vx.tolist()]}")
        if green == 0.0:
            ok = bool(((s.vehicle.vx < 0.6) & (s.waypoint_idx < target)).all())
        else:
            ok = bool((s.waypoint_idx > target + 5).all())
        if not ok:
            raise AssertionError(f"[agents] {label}: an agent did not stop short of / pass its light")
    return launches


@contextlib.contextmanager
def in_temp_dir():
    """cwd is a fresh temporary directory (the CLIs write models/<name>
    under the cwd) for the duration; deleted on exit."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            yield tmp
        finally:
            os.chdir(cwd)


def trainer_phase(torch, RC):
    """[trainer]: the training entry point, carla_ppo_tpu_torch.cli.train.main
    in-process at full width (1024 envs, PPOConfig defaults, latent obs
    through the converted de-prop seg VAE under models/torch/, the default
    --policy_dtype mixed), 2 iterations with an eval after each, then main
    again to 3 iterations, which must resume (at iteration >= 1) and end at
    3; best_score.json and a best checkpoint must exist. Then 2 iterations
    with --policy_dtype float32. Every run's loss and returns must be
    finite, and both camera kernels must have launched. The model dirs are
    in a temporary directory; two settings differ from the CLI's defaults
    there: an autosave every iteration (so the resume point is the last
    iteration) and a 2048-step eval cap (an untrained policy may drive
    slowly for long). Returns the launch counts over the phase."""
    from carla_ppo_tpu_torch.cli import train as train_cli
    from carla_ppo_tpu_torch.training import loop

    @dataclasses.dataclass
    class SmokeSettings(loop.TrainerSettings):
        checkpoint_interval: int = 1
        eval_max_steps: int = 2048

    runs = []

    class RecordingTrainer(loop.Trainer):
        def train(self, num_iterations=None):
            start = self.iteration
            metrics = super().train(num_iterations)
            runs.append(dict(start=start, end=self.iteration, metrics=metrics,
                             model_dir=os.path.abspath(self.model_dir)))
            return metrics

    argv = ["--vae_model", DEPROP_VAE, "--eval_interval", "1", "--eval_envs", "4"]
    saved = (train_cli.TrainerSettings, train_cli.Trainer)
    train_cli.TrainerSettings, train_cli.Trainer = SmokeSettings, RecordingTrainer
    try:
        with in_temp_dir():
            reset_launch_counts(RC)
            h0 = time.perf_counter()
            train_cli.main(argv + ["--model_name", "smoke", "--num_episodes", "2"])
            train_cli.main(argv + ["--model_name", "smoke", "--num_episodes", "3"])
            train_cli.main(argv + ["--model_name", "smoke_f32", "--num_episodes", "2",
                                   "--policy_dtype", "float32"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - h0
            launches = launch_counts(RC)
            model_dir = runs[1]["model_dir"]
            best_json = os.path.join(model_dir, "best_score.json")
            best = sorted(int(e) for e in os.listdir(os.path.join(model_dir, "checkpoints")) if e.isdigit())
            if not os.path.isfile(best_json) or not best:
                raise AssertionError(f"no best_score.json or best checkpoint in {model_dir}")
            with open(best_json) as f:
                best_score = json.load(f)
    finally:
        train_cli.TrainerSettings, train_cli.Trainer = saved
    first, second, f32 = runs
    log(f"[trainer] cli.train 1024 envs, mixed: run 1 iterations {first['start']}->{first['end']}, "
        f"run 2 iterations {second['start']}->{second['end']}; float32 iterations "
        f"{f32['start']}->{f32['end']}; {seconds:.2f} s for the three runs; best checkpoints {best}, "
        f"best_score.json {best_score}")
    if first["end"] != 2 or second["start"] < 1 or second["end"] != 3:
        raise AssertionError(f"the second cli.train run did not resume and end at 3: {runs}")
    for r in runs:
        bad = [k for k in ("train_loss/loss", "train/returns") if not math.isfinite(r["metrics"][k])]
        if bad:
            raise AssertionError(f"non-finite training metrics through cli.train: {bad}")
    log(f"[launches] trainer path (the three cli.train runs): {launches}")
    if launches["ground_pass"] <= 0 or launches["composite"] <= 0:
        raise AssertionError(f"a camera kernel never launched under cli.train: {launches}")
    return launches


def pixel_phase(torch, RC, smi):
    """[pixels]: end-to-end pixel PPO with the joint VAE through cli.train
    in-process at full width (1024 envs, PPOConfig defaults, the shipped
    widths: 2,951,842 parameters) with the README's turnkey recipe (lr 3e-4,
    --kl_target 0.015, --freeze_on_solve 2, --obs pixels --deprop_aux 1),
    warm-started from the converted de-prop VAE: 2 iterations, then resumed
    to 3 (the resumed run must not warm-start again), evals every 2
    iterations capped at PIXEL_EVAL_STEPS. Every loss and both groups'
    gradient norms must be finite, and every rollout must launch the ground
    pass and the class-only composite horizon + 1 = 129 times. Logs the
    card's peak memory over the phase (torch.cuda.max_memory_allocated).
    Returns the launch counts of the phase."""
    from carla_ppo_tpu_torch.cli import train as train_cli
    from carla_ppo_tpu_torch.training import loop, pixels, ppo

    @dataclasses.dataclass
    class SmokeSettings(loop.TrainerSettings):
        checkpoint_interval: int = 1
        eval_max_steps: int = PIXEL_EVAL_STEPS

    runs, iterations, rollout_launches, warm_starts = [], [], [], []

    class RecordingTrainer(loop.Trainer):
        def train(self, num_iterations=None):
            start = self.iteration
            metrics = super().train(num_iterations)
            runs.append(dict(start=start, end=self.iteration))
            return metrics

    real = {name: getattr(pixels, name) for name in
            ("pixel_rollout", "pixel_train_iteration", "warm_start_from_vae")}

    def counted_rollout(*args, **kwargs):
        before = launch_counts(RC)
        out = real["pixel_rollout"](*args, **kwargs)
        torch.cuda.synchronize()
        after = launch_counts(RC)
        rollout_launches.append({k: after[k] - before[k] for k in before})
        return out

    def recorded_iteration(*args, **kwargs):
        state, envs, m = real["pixel_train_iteration"](*args, **kwargs)
        iterations.append({k: float(v) for k, v in m.items()})
        return state, envs, m

    def counted_warm_start(*args, **kwargs):
        warm_starts.append(1)
        return real["warm_start_from_vae"](*args, **kwargs)

    config = ppo.PPOConfig()
    saved = (train_cli.TrainerSettings, train_cli.Trainer)
    train_cli.TrainerSettings, train_cli.Trainer = SmokeSettings, RecordingTrainer
    pixels.pixel_rollout, pixels.pixel_train_iteration = counted_rollout, recorded_iteration
    pixels.warm_start_from_vae = counted_warm_start
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with in_temp_dir():
            reset_launch_counts(RC)
            h0 = time.perf_counter()
            train_cli.main(PIXEL_ARGV + ["--model_name", "pixels", "--num_episodes", "2"])
            train_cli.main(PIXEL_ARGV + ["--model_name", "pixels", "--num_episodes", "3"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - h0
            launches = launch_counts(RC)
            peak = torch.cuda.max_memory_allocated()
    finally:
        train_cli.TrainerSettings, train_cli.Trainer = saved
        for name, fn in real.items():
            setattr(pixels, name, fn)
        torch.cuda.empty_cache()
    first, second = runs
    log(f"[pixels] {smi}: cli.train --obs pixels, 1024 envs: run 1 iterations {first['start']}->"
        f"{first['end']}, run 2 {second['start']}->{second['end']}, {seconds:.2f} s for both runs "
        f"with construction and evals; warm starts {len(warm_starts)}; card memory peak "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    if first["end"] != 2 or second["start"] < 1 or second["end"] != 3 or len(warm_starts) != 1:
        raise AssertionError(f"the pixel runs did not warm-start once and resume to 3: {runs}, "
                             f"{len(warm_starts)} warm starts")
    keys = ("train_loss/loss", "train_loss/policy", "train_loss/value", "train_loss/vae_recon",
            "train_loss/vae_kl", "train_grad/policy_norm", "train_grad/encoder_norm",
            "train/approx_kl", "train/update_skipped")
    for i, m in enumerate(iterations):
        log(f"[pixels] iteration {i}: " + " ".join(f"{k}={m[k]:.6g}" for k in keys)
            + f"; rollout launches {rollout_launches[i]}")
        bad = [k for k in keys if not math.isfinite(m[k])]
        if bad:
            raise AssertionError(f"non-finite pixel training metrics: {bad}")
    for i, got in enumerate(rollout_launches):
        if got["ground_pass"] != config.horizon + 1 or got["composite"] != config.horizon + 1:
            raise AssertionError(f"pixel rollout {i} launched {got}, not {config.horizon + 1} of "
                                 "the ground pass and the composite")
    return launches


def eval_phase(RC, smi, tag, agent_dir, argv, envs, steps, tolerance, kernels,
               require_finished_or_running=True, require_overtakes=False):
    """cli.run_eval --no_video of a converted shipped agent (copied into a
    temporary models/torch/), capped at `steps` with `envs` envs, held
    against the JAX package's greedy eval of the same orbax checkpoint at
    the same cap (`<agent_dir>/reference_eval_<steps>.json`): the mean
    distance within `tolerance`, no failed episode where required,
    overtakes where required, and each of `kernels` launched. main() runs
    it on the converted latent agent (step 1450, de-prop VAE), the RGB
    latent agent (step 90, --vae_source rgb) and the turnkey pixel agent
    (step 625), each 8 envs and 6000 steps within 5% with no failed
    episode, and on the traffic agent (step 560) with its training traffic
    (4 lane-keeping NPCs), 16 envs and 3000 steps within 10% with
    overtakes (the NPC spawns come from each package's own generator).
    Missing converted files fail the phase. Returns the launch counts of
    the run."""
    from carla_ppo_tpu_torch.cli import run_eval as eval_cli
    from carla_ppo_tpu_torch.envs.types import TerminationReason

    name = os.path.basename(agent_dir)
    with open(os.path.join(agent_dir, f"reference_eval_{steps}.json")) as f:
        ref = json.load(f)
    if ref["max_steps"] != steps or ref["num_envs"] != envs:
        raise AssertionError(f"the reference eval is of another drive: {ref['command']}")
    with in_temp_dir() as tmp:
        shutil.copytree(agent_dir, os.path.join(tmp, "models", "torch", name))
        reset_launch_counts(RC)
        h0 = time.perf_counter()
        m = eval_cli.main(["--model_name", f"torch/{name}", "--num_envs", str(envs), "--no_video",
                           "--eval_max_steps", str(steps)] + argv)
        seconds = time.perf_counter() - h0
        launches = launch_counts(RC)
    want = ref["metrics"]["eval/distance_traveled"]
    got = m["eval/distance_traveled"]
    reasons = {TerminationReason(i).name: m[f"eval/termination_reasons/{i}"]
               for i in range(len(TerminationReason)) if m[f"eval/termination_reasons/{i}"]}
    want_reasons = {TerminationReason(i).name: ref["metrics"][f"eval/termination_reasons/{i}"]
                    for i in range(len(TerminationReason))
                    if ref["metrics"][f"eval/termination_reasons/{i}"]}
    log(f"[{tag}] {smi}: run_eval torch/{name}, {envs} envs, {steps} steps cap, {seconds:.2f} s: "
        f"laps {m['eval/laps_completed']:.6g}, distance {got:.6g} m (JAX CPU reference {want:.6g} m, "
        f"{100 * (got / want - 1):+.3f}%), average centre deviation "
        f"{m['eval/average_center_lane_deviation']:.6g} m, speed {m['eval/average_speed']:.6g} km/h, "
        f"overtakes {m['eval/overtakes']:.6g} (reference {ref['metrics']['eval/overtakes']:.6g}), "
        f"episodes by reason {reasons} (reference {want_reasons}), collisions "
        f"{reasons.get('COLLISION', 0.0):g}; launches {launches}")
    failed = {k: v for k, v in reasons.items() if k not in ("RUNNING", "LAPS_DONE")}
    if require_finished_or_running and failed:
        raise AssertionError(f"the shipped agent {name}'s episodes failed: {failed}")
    if abs(got / want - 1.0) > tolerance:
        raise AssertionError(f"distance {got} m is not within {tolerance:.0%} of the JAX reference {want} m")
    if require_overtakes and not m["eval/overtakes"] > 0:
        raise AssertionError(f"the traffic agent made no overtake: {m['eval/overtakes']}")
    if any(launches[k] <= 0 for k in kernels):
        raise AssertionError(f"a camera kernel never launched under cli.run_eval: {launches}")
    return launches


def vae_pipeline_phase(torch, RC, states, params):
    """[vae_pipeline]: cli.collect_data at its defaults (NPCs on) but
    VAE_IMAGES images into a temporary directory, cli.train_vae --epochs
    VAE_EPOCHS (rgb source, seg target) on them, load_vae of the result and
    one encode of the RGB frames of `states` (1024 envs) on the card: every
    pair and epoch there, finite losses and latents, and the ground pass and
    the depth-and-sky composite launched (a saved pair is one RGB render
    whose classes are its seg frame). Returns the launch counts over the
    phase."""
    from carla_ppo_tpu_torch.cli import collect_data, train_vae
    from carla_ppo_tpu_torch.models import vae_common
    from carla_ppo_tpu_torch.ops import rasterizer as R

    with in_temp_dir():
        reset_launch_counts(RC)
        h0 = time.perf_counter()
        n = collect_data.main(["--output_dir", "data", "--num_images", str(VAE_IMAGES)])
        history = train_vae.main(["--dataset", "data", "--epochs", str(VAE_EPOCHS),
                                  "--models_dir", "vae_models"])
        model_dir = os.path.join("vae_models", "seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_data")
        vae = vae_common.load_vae(model_dir, device="cuda")
        frames = R.render_rgb_batch(states, params)
        with torch.no_grad():
            z = vae.encode(frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - h0
        launches = launch_counts(RC)
    log(f"[vae_pipeline] collect_data {n} pairs ({3 * n} env steps, one env), train_vae "
        f"{len(history['val_loss'])} epochs, an encode, {seconds:.2f} s in all; train losses "
        f"{history['train_loss']}, val losses {history['val_loss']}; encode of {tuple(frames.shape)} "
        f"RGB frames -> z {tuple(z.shape)}; launches {launches}")
    if n != VAE_IMAGES or len(history["val_loss"]) != VAE_EPOCHS:
        raise AssertionError(f"the VAE pipeline fell short: {n} pairs, {history}")
    if not all(math.isfinite(v) for v in history["val_loss"] + history["train_loss"]):
        raise AssertionError(f"non-finite VAE losses: {history}")
    if z.shape != (states.batch_size, 64) or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"bad latents from the trained VAE: {tuple(z.shape)}")
    if any(launches[k] <= 0 for k in ("ground_pass", "composite_depth_sky")):
        raise AssertionError(f"a camera kernel never launched in the VAE pipeline: {launches}")
    return launches


class FrameView:
    """An interactive env as eval_host.run_eval drives it, with render(mode)
    answered by the env's pygame-free half (the card's machine has no
    pygame): the spectator frame, RGB uint8 from the chase camera. After
    the reset and every VIDEO_CHECK_EVERY-th step `check(env)` holds that
    state's frames against the plain versions. `route_id`: the route the
    JAX reference's reset drew; reset re-spawns there (eval spawns at the
    route's start), so both packages drive the same route."""

    def __init__(self, env, route_id, check):
        self.env, self.route_id, self.check = env, route_id, check
        self.steps = 0

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, is_training: bool = True):
        import torch

        from carla_ppo_tpu_torch.envs import route_env

        env = self.env
        obs = env.reset(is_training)
        if self.route_id is not None:
            dev = env.device
            env.state = route_env.reset_on_routes(
                env.params, torch.tensor([self.route_id], dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.tensor([is_training], device=dev))
            env.extra_info = []
            obs = env.step(None)[0]
        self.steps = 0
        return obs

    def step(self, action):
        out = self.env.step(action)
        self.steps += 1
        return out

    def render(self, mode: str = "human"):
        spec, _ = self.env.render_frames()
        self.env.extra_info = []
        if self.steps % VIDEO_CHECK_EVERY == 0:
            self.check(self.env)
        return spec


@contextlib.contextmanager
def ground_pass_shapes(RC):
    """Count the ground pass's launches by frame size, {(B, H*W):
    launches}, at each launch while the block runs (the camera's dispatch
    calls RC.ground_pass_cuda through the module). Yields the counts."""
    counts = defaultdict(int)
    real = RC.ground_pass_cuda

    def counted(win_cols, payload, slab, stripes, sky_px, hw, style_consts):
        out = real(win_cols, payload, slab, stripes, sky_px, hw, style_consts)
        counts[(win_cols.shape[0], hw)] += 1
        return out

    RC.ground_pass_cuda = counted
    try:
        yield counts
    finally:
        RC.ground_pass_cuda = real


def video_phase(torch, RC, smi, dev):
    """[video]: greedy episodes of the converted agents through the
    interactive envs (envs/gym_api) and eval_host.run_eval, each to an .avi
    in a temporary directory, held against the JAX Trainer's
    record_eval_video of the same orbax checkpoint at the same cap
    (<agent>/reference_video_<steps>.json): the same termination reason and
    step count, distance and reward within VIDEO_TOLERANCE. The .avi reads
    back with steps + 1 frames of 180x320x3. After the reset and every
    VIDEO_CHECK_EVERY steps the episode's own kernel frames (the dashcam
    and the chase camera, banked on the route env) equal the plain
    versions, and on the RGB episode render_rgb's depth-and-sky frame too;
    the ground pass, the composite and the depth-and-sky mode must launch.
    The ground pass's launches are split by contract, counted by frame size
    at the launch (ground_pass_shapes) and by episode: the route episode's,
    all banked (v3d), which must equal its ground-pass launches and be
    above 0; the other episodes' B=1 chase (v4) and dashcam (v3c) frames,
    which must make up theirs; the three must sum to the phase's launches,
    each above 0. The RGB check's own render_rgb launches are not the
    phase's. Then times each kernel at B=1 on these contracts (CUDA
    events, 200 launches each). The episodes: latent_agent on CarlaLapEnv
    for 1500 steps, route_latent on CarlaRouteEnv for 500 (on the route
    the JAX reference's reset drew), rgb_latent for 300 (the depth-and-sky
    mode at B=1) and pixel_turnkey for 300, each env a batch of one on the
    card, each frame the env's spectator view (the pygame-free half of
    render: the card's machine has no pygame). Returns (launches over the
    phase, ground-pass launches by contract, ms per B=1 launch by kernel
    and camera)."""
    import cv2

    from carla_ppo_tpu_torch.envs.types import TerminationReason
    from carla_ppo_tpu_torch.ops import rasterizer as R
    from carla_ppo_tpu_torch.training.eval_host import run_eval
    from carla_ppo_tpu_torch.training.loop import Trainer, TrainerSettings
    from carla_ppo_tpu_torch.training.ppo import PPOConfig

    consts = R.style_constants(R.RoadStyle())
    mismatched, checked = defaultdict(int), defaultdict(int)

    def plain_classes(state, params, cam):
        win, pay = R.prep_windows(state, params, cam)
        slab, stripes, sky_px, depth = R._device_layout(cam, str(dev))
        ground = R.ground_pass_plain(win, pay, slab, stripes, sky_px, cam.height * cam.width, consts)
        rows = R.prep_candidates(state, params, cam)
        return ground, rows, depth, R.composite_plain(rows, depth, ground, cam.width)

    counted = {}

    def check(env, rgb: bool):
        tag = "banked " if env.params.track.banked else ""
        counted["state " + tag] = (env.state, env.params, env._dash_cam, env._spec_cam)
        _, _, _, dash = plain_classes(env.state, env.params, env._dash_cam)
        mismatched[tag + "dash 80x160"] += int((env._dash.view(1, -1) != dash).sum())
        checked[tag + "dash 80x160"] += 1
        _, _, _, chase = plain_classes(env.state, env.params, env._spec_cam)
        chase_rgb = (R.seg_to_rgb(chase.view(env._spec_cam.height, env._spec_cam.width)) * 255)
        chase_rgb = chase_rgb.to(torch.uint8).cpu().numpy()
        mismatched[tag + "chase 180x320"] += int((env.viewer_image != chase_rgb).any(-1).sum())
        checked[tag + "chase 180x320"] += 1
        if rgb:  # render_rgb's kernel launches, counted out of the phase's
            saved, saved_shapes = dict(RC.LAUNCHES), dict(by_shape)
            got = R.render_rgb(env.state, env.params, env._dash_cam)
            ground, rows, depth, _ = plain_classes(env.state, env.params, env._dash_cam)
            want = R._shade_rgb(*R.composite_plain(rows, depth, ground, env._dash_cam.width,
                                                   return_depth_sky=True), env._dash_cam)[0]
            RC.LAUNCHES.update(saved)
            by_shape.clear()
            by_shape.update(saved_shapes)
            mismatched["depth-and-sky 80x160"] += int((got != want).any(-1).sum())
            checked["depth-and-sky 80x160"] += 1

    chase_hw, dash_hw = 180 * 320, 80 * 160
    contracts = {"v4": 0, "v3d": 0, "v3c": 0}
    RC.reset_launch_counts()
    with in_temp_dir() as tmp, ground_pass_shapes(RC) as by_shape:
        for tag, agent_dir, settings_kw, config_kw, steps in VIDEO_EPISODES:
            name = os.path.basename(agent_dir)
            with open(os.path.join(agent_dir, f"reference_video_{steps}.json")) as f:
                ref = json.load(f)
            if ref["max_steps"] != steps:
                raise AssertionError(f"the reference episode is of another cap: {ref['command']}")
            want = ref["episode"]
            shutil.copytree(agent_dir, os.path.join(tmp, "models", "torch", name))
            settings = TrainerSettings(model_name=f"torch/{name}", models_root="models",
                                       eval_interval=0, heldout_eval=0, **settings_kw)
            # The episode's launches include the env's first render.
            before, shapes_before = RC.LAUNCHES["ground_pass"], dict(by_shape)
            trainer = Trainer(settings, PPOConfig(num_envs=8, **config_kw), device=dev)
            env = trainer.make_video_env()
            if type(env).__name__ != want["env"]:
                raise AssertionError(f"{type(env).__name__} where the reference drove {want['env']}")
            view = FrameView(env, want["route_id"] if want["env"] == "CarlaRouteEnv" else None,
                             lambda e, rgb=(tag == "rgb"): check(e, rgb))
            video = os.path.join(tmp, f"{tag}.avi")
            h0 = time.perf_counter()
            reward = run_eval(view, trainer._predict_fn(), video_filename=video, max_steps=steps)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - h0
            shapes = {k: n - shapes_before.get(k, 0) for k, n in by_shape.items()}
            episode_launches = RC.LAUNCHES["ground_pass"] - before
            if env.params.track.banked != (want["env"] == "CarlaRouteEnv"):
                raise AssertionError(f"the {tag} episode's track is banked={env.params.track.banked}")
            if env.params.track.banked:
                if episode_launches <= 0:
                    raise AssertionError(f"the {tag} episode launched no banked ground pass")
                contracts["v3d"] += episode_launches
            else:
                if shapes.get((1, chase_hw), 0) + shapes.get((1, dash_hw), 0) != episode_launches:
                    raise AssertionError(f"the {tag} episode launched the ground pass at other "
                                         f"sizes than B=1 80x160 and 180x320: {shapes}")
                contracts["v4"] += shapes.get((1, chase_hw), 0)
                contracts["v3c"] += shapes.get((1, dash_hw), 0)
            log(f"[launches] {tag} episode: ground_pass {episode_launches}, by (B, H*W) {shapes}")
            s = env.state
            got = {"reward": reward, "distance_traveled": float(s.distance_traveled),
                   "laps_completed": float(s.laps_completed), "step_count": int(s.step_count),
                   "termination_reason": int(s.termination_reason)}
            cap = cv2.VideoCapture(video)
            frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            ok, first = cap.read()
            cap.release()
            trainer.close()
            env.close()
            n = view.steps
            gaps = {k: got[k] / want[k] - 1.0 if want[k] else got[k] - want[k]
                    for k in ("reward", "distance_traveled")}
            log(f"[video] {smi}: {tag} episode of torch/{name} ({type(env).__name__}"
                + (f", route {want['route_id']}" if view.route_id is not None else "")
                + f"): {n} steps in {seconds:.3f} s; "
                f"reward {got['reward']:.6g} (JAX CPU {want['reward']:.6g}, {100 * gaps['reward']:+.4f}%), "
                f"distance {got['distance_traveled']:.6g} m (JAX CPU {want['distance_traveled']:.6g} m, "
                f"{100 * gaps['distance_traveled']:+.4f}%), laps {got['laps_completed']:.6g} (JAX CPU "
                f"{want['laps_completed']:.6g}), step count {got['step_count']} (JAX CPU "
                f"{want['step_count']}), termination {TerminationReason(got['termination_reason']).name} "
                f"(JAX CPU {TerminationReason(want['termination_reason']).name}); video {frames} frames "
                f"of {None if not ok else first.shape}")
            if got["termination_reason"] != want["termination_reason"] or (
                    got["step_count"] != want["step_count"]):
                raise AssertionError(f"the {tag} episode ended otherwise than the JAX reference's")
            if any(abs(g) > VIDEO_TOLERANCE for g in gaps.values()):
                raise AssertionError(f"the {tag} episode is not within {VIDEO_TOLERANCE:.0%} of the "
                                     f"JAX reference: {gaps}")
            if got["termination_reason"] not in (int(TerminationReason.RUNNING),
                                                 int(TerminationReason.LAPS_DONE)):
                raise AssertionError(f"the {tag} episode failed: {got}")
            if frames != n + 1 or not ok or first.shape != (180, 320, 3):
                raise AssertionError(f"the {tag} video holds {frames} frames of "
                                     f"{None if not ok else first.shape}, not {n + 1} of 180x320x3")
    launches = dict(RC.LAUNCHES)
    # The kernels at B=1 on the last checked states (these launches are
    # not the phase's).
    b1_ms = {}
    for tag, (state, params, dash_cam, spec_cam) in ((k[6:], v) for k, v in counted.items()
                                                      if k.startswith("state ")):
        for cam in (dash_cam, spec_cam):
            win, pay = R.prep_windows(state, params, cam)
            slab, stripes, sky_px, depth = R._device_layout(cam, str(dev))
            hw = cam.height * cam.width
            b1_ms[f"ground_pass {tag}{cam.height}x{cam.width}"] = cuda_ms(
                torch, lambda: RC.ground_pass_cuda(win, pay, slab, stripes, sky_px, hw, consts), 200)
            if cam is dash_cam and not tag:
                ground = RC.ground_pass_cuda(win, pay, slab, stripes, sky_px, hw, consts)
                rows = R.prep_candidates(state, params, cam)
                b1_ms["composite 80x160"] = cuda_ms(
                    torch, lambda: RC.composite_cuda(rows, depth, ground, cam.width), 200)
                b1_ms["composite_depth_sky 80x160"] = cuda_ms(
                    torch, lambda: RC.composite_depth_sky_cuda(rows, depth, ground, cam.width), 200)
    log(f"[timing] {smi}: the kernels at B=1 (CUDA events, 200 launches each): "
        + ", ".join(f"{k} {v:.6f} ms" for k, v in sorted(b1_ms.items())))
    log(f"[video] kernel frames against the plain versions, mismatched pixels: "
        + ", ".join(f"{k} {mismatched[k]} in {checked[k]} frames" for k in sorted(checked)))
    log(f"[launches] video phase: {launches}; ground_pass by contract: {contracts}")
    if any(mismatched.values()) or not checked:
        raise AssertionError(f"a B=1 kernel frame disagrees with its plain version: {dict(mismatched)}")
    if any(launches[k] <= 0 for k in ("ground_pass", "composite", "composite_depth_sky")):
        raise AssertionError(f"a camera kernel never launched in the video phase: {launches}")
    if sum(contracts.values()) != launches["ground_pass"] or not all(contracts.values()):
        raise AssertionError(f"the ground pass's launches by contract {contracts} do not make up "
                             f"the phase's {launches['ground_pass']}")
    return launches, contracts, b1_ms


def inspect_phase(torch, smi, dev, states, params):
    """[inspect]: the inspection CLIs (cli/inspect_vae, inspect_agent,
    vae_plots) on the converted weights on `dev`, each held against the same
    call on the CPU in this process:
    - inspect_vae --dump --dims 10 of the de-prop seg VAE and of the RGB VAE
      (rgb_bce_..._data), a (10 x 80) x (9 x 160) x 3 sheet, within 1 uint8
      level of the CPU's on all but 0.1% of pixels (seg class flips);
    - inspect_agent --dump of torch/latent_agent with the de-prop VAE, its
      13 steer, throttle and value numbers within 1e-4;
    - vae_plots' sweep arrays (both VAEs) and the RGB VAE's reconstructions
      of six RGB frames rendered from `states` by the port's camera and
      written as collect_data lays them out (rgb/<i>.png), within 1e-4;
    - both windows through tests/torch_tk_stub.py (a recording stand-in for
      tkinter and PIL.ImageTk: the card's machine has no tkinter), driven by
      a latent slider, Reset and "Set z by image" (inspect_vae, RGB VAE) and
      by a latent and a speed slider (inspect_agent): every image shown
      equals decode_image of the z the script set, the action label the
      policy's numbers;
    - utils/profiling: the decode ms per call at [1, 64]
      (profiling.timeit_device), device_trace of 6 decodes keeping the
      kernel of each launch it records, in one of 3 traces (and what a
      plain torch.profiler session of them keeps), and the phase's parts
      (profiling.PhaseTimer)."""
    import numpy as np

    from carla_ppo_tpu_torch.cli import inspect_agent, inspect_vae, vae_plots
    from carla_ppo_tpu_torch.models import vae_common
    from carla_ppo_tpu_torch.ops import rasterizer as R
    from carla_ppo_tpu_torch.utils import profiling
    from carla_ppo_tpu_torch.utils.datasets import load_images, preprocess_rgb_frame
    from carla_ppo_tpu_torch.utils.png import read_png, write_png
    from tests import torch_tk_stub

    timer = profiling.PhaseTimer()
    card = ["--device", str(dev)]
    # models/torch/latent_agent by its absolute path (the CLI joins "models"
    # and --model_name, so any cwd will do).
    agent_argv = ["--model_name", LATENT_AGENT, "--vae_model", DEPROP_VAE]
    with tempfile.TemporaryDirectory() as tmp:
        with timer.phase("frames"):
            rgb_dir = os.path.join(tmp, "data", "rgb")
            os.makedirs(rgb_dir)
            frames = R.render_rgb_batch(states, params).cpu().numpy()
            for i, frame in enumerate(frames):  # as collect_data.save_pair writes them
                write_png(os.path.join(rgb_dir, f"{i}.png"),
                          (np.clip(frame, 0, 1) * 255).astype(np.uint8))

        vaes, sheets = {}, {}
        for tag, model_dir in (("seg", DEPROP_VAE), ("rgb", RGB_VAE)):
            with timer.phase("vae sweep (card)"):
                card_png = os.path.join(tmp, f"{tag}_card.png")
                inspect_vae.main(["--model_dir", model_dir, "--dump", card_png,
                                  "--dims", str(INSPECT_DIMS), *card])
            with timer.phase("vae sweep (cpu)"):
                cpu_vae = vae_common.load_vae(model_dir, device="cpu")
                cpu_png = os.path.join(tmp, f"{tag}_cpu.png")
                inspect_vae.dump_sweep(cpu_vae, cpu_png, dims=INSPECT_DIMS)
            vaes[tag] = (vae_common.load_vae(model_dir, device=dev), cpu_vae)
            got, want = read_png(card_png), read_png(cpu_png)
            if got.shape != (INSPECT_DIMS * 80, 9 * 160, 3) or got.shape != want.shape:
                raise AssertionError(f"the {tag} sweep sheet is {got.shape}, the CPU's {want.shape}")
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
            sheets[tag] = (float((diff > 0).mean()), float((diff > 1).mean()), int(diff.max()))
            if sheets[tag][1] > (INSPECT_OFF_SHARE if tag == "seg" else 0.0):
                raise AssertionError(f"the {tag} sweep sheet is off the CPU's: {sheets[tag]}")

        with timer.phase("agent sweep"):
            rows = np.array(inspect_agent.main([*agent_argv, "--dump", *card]))
            with contextlib.redirect_stdout(io.StringIO()):  # the same lines again
                cpu_rows = np.array(inspect_agent.main([*agent_argv, "--dump", "--device", "cpu"]))
        agent_err = float(np.abs(rows - cpu_rows).max())
        if rows.shape != (13, 4) or not agent_err <= INSPECT_TOL:
            raise AssertionError(f"the agent sweep is off the CPU's by {agent_err}: {rows} vs {cpu_rows}")

        plot_err = {}
        with timer.phase("plot arrays"):
            for tag, (model, cpu_model) in vaes.items():
                _, images = vae_plots.latent_sweep(model, 8, 9, 3.0)
                _, cpu_images = vae_plots.latent_sweep(cpu_model, 8, 9, 3.0)
                plot_err[f"{tag} sweep"] = float(np.abs(images - cpu_images).max())
            src, recon = vae_plots.reconstructions(vaes["rgb"][0], os.path.dirname(rgb_dir))
            cpu_src, cpu_recon = vae_plots.reconstructions(vaes["rgb"][1], os.path.dirname(rgb_dir))
            plot_err["rgb reconstructions"] = float(np.abs(recon - cpu_recon).max())
        if (recon.shape != (INSPECT_FRAMES, 80, 160, 3) or not np.array_equal(src, cpu_src)
                or not max(plot_err.values()) <= INSPECT_TOL):
            raise AssertionError(f"vae_plots' arrays are off the CPU's: {plot_err}, {recon.shape}")

        with timer.phase("vae window"), torch_tk_stub.installed() as tk:
            rgb_vae = vaes["rgb"][0]
            inspect_vae.run_ui(rgb_vae, rgb_dir)
            tk.scale("z3").command("1.5")
            tk.button("Reset").command()
            np.random.seed(7)
            tk.button("Set z by image").command()
            shown = list(tk.images)
        one = np.zeros(64, np.float32)
        one[3] = 1.5
        loaded = load_images(rgb_dir, preprocess_rgb_frame, limit=50)
        np.random.seed(7)
        with torch.no_grad():
            seeded = rgb_vae.encode(torch.as_tensor(loaded[np.random.randint(len(loaded))][None],
                                                    device=dev))[0].cpu().numpy()
        zero = np.zeros(64, np.float32)
        want_z = [zero, one, zero, seeded]
        ui_ok = len(shown) == 4 and all(
            np.array_equal(img[::3, ::3], inspect_vae.decode_image(rgb_vae, z))
            for img, z in zip(shown, want_z))

        with timer.phase("agent window"), torch_tk_stub.installed() as tk:
            inspect_agent.main([*agent_argv, *card])
            tk.scale("z2").command("1.0")
            tk.scale("speed").command("12.0")
            act = inspect_agent.make_act(inspect_agent.load_agent(LATENT_AGENT, 67, device=dev))
        two = np.zeros(64, np.float32)
        two[2] = 1.0
        a, val = act(two, np.float32([0.0, 0.5, 12.0]))
        label = [w for w in tk.labels() if "font" in w.options][0].options["text"]
        want_label = f"steer    {float(a[0]):+.3f}\nthrottle {float(a[1]):.3f}\nvalue    {val:.2f}"
        seg_vae = vaes["seg"][0]
        agent_ui_ok = len(tk.images) == 3 and label == want_label and all(
            np.array_equal(img[::3, ::3], inspect_vae.decode_image(seg_vae, z))
            for img, z in zip(tk.images, [np.zeros(64, np.float32), two, two]))

        with timer.phase("decode timing"):
            z1 = torch.zeros(1, 64, device=dev)
            decode_ms = {}
            with torch.no_grad():
                for tag, (model, _) in vaes.items():
                    decode_ms[tag] = 1e3 * profiling.timeit_device(model.generate_from_latent, z1,
                                                                   iters=DECODE_ITERS)
                # A short block late in a long process: device_trace must keep
                # the kernel of each launch; a plain session of the same block
                # can lose them all. device_trace itself lost a block's kernels
                # in 1 of 60 traces (scripts/profiler_drop_probe.py, PERF.md
                # section 6), so it gets TRACE_TRIES traces to keep them all.
                def block():
                    for model, _ in vaes.values():
                        for _ in range(TRACE_DECODES):
                            model.generate_from_latent(z1)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)

                def kept(session, name):
                    """(launches whose kernel the trace holds, launches)."""
                    trace_dir = os.path.join(tmp, name)
                    with session(trace_dir):
                        block()
                    with open(os.path.join(trace_dir, os.listdir(trace_dir)[0])) as f:
                        events = json.load(f)["traceEvents"]
                    launched = {e["args"].get("correlation") for e in events
                                if profiling.is_kernel_launch(e)}
                    ran = {e["args"].get("correlation") for e in events if e.get("cat") == "kernel"}
                    return len(launched & ran), len(launched)

                helper = []
                while len(helper) < TRACE_TRIES and (not helper or helper[-1][0] < helper[-1][1]):
                    helper.append(kept(lambda d: profiling.device_trace(d, device=dev),
                                       f"device_trace{len(helper)}"))
                plain = kept(lambda d: torch.profiler.profile(
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(d)), "plain")

    log(f"[inspect] {smi}: sweep sheets against the CPU's (share of pixels off, share more than 1 "
        f"level off, max levels) {sheets}; agent sweep max |card - cpu| {agent_err:.3g} "
        f"(steer {', '.join(f'{r[1]:+.4f}' for r in rows)}; throttle "
        f"{', '.join(f'{r[2]:.4f}' for r in rows)}; value {', '.join(f'{r[3]:.3f}' for r in rows)}); "
        f"plot arrays max |card - cpu| {plot_err}; windows: vae {len(shown)} images, agent "
        f"{len(tk.images)} images, label {label!r}; decode ms per call at [1, 64] "
        f"(timeit_device, {DECODE_ITERS} calls) {', '.join(f'{k} {v:.4f}' for k, v in decode_ms.items())}; "
        f"{len(vaes) * TRACE_DECODES} decodes traced, launches whose kernel the trace holds: device_trace "
        f"{', then '.join(f'{k} of {n}' for k, n in helper)}, a plain torch.profiler session "
        f"{plain[0]} of {plain[1]}; parts: "
        + "; ".join(timer.summary().splitlines()))
    if not ui_ok or not agent_ui_ok:
        raise AssertionError(f"a window's images or label differ from decode_image / the policy "
                             f"(vae window {ui_ok}, agent window {agent_ui_ok}: {label!r} vs {want_label!r})")
    if dev.type == "cuda" and not 0 < helper[-1][1] == helper[-1][0]:
        raise AssertionError(f"device_trace kept the kernels of {helper} launches")


def _first(states, n: int):
    """The first n envs of a batch."""
    from carla_ppo_tpu_torch.envs.types import map_tensors

    return map_tensors(lambda t: t[:n], states)


if __name__ == "__main__":
    sys.exit(main())

