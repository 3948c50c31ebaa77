"""Host-side greedy evaluation with video recording (port of
carla_ppo_tpu/training/eval_host.py).

One greedy episode through an interactive env (envs/gym_api), every
rendered frame appended to an .avi. The Trainer's record_eval and
cli.run_eval's videos call it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from carla_ppo_tpu_torch.utils.video import VideoRecorder


def run_eval(
    env,
    predict_fn: Callable,
    video_filename: Optional[str] = None,
    max_steps: int = 3000,
) -> float:
    """Run one greedy episode; returns its total reward. `predict_fn(env)
    -> (action, value)` builds the observation and runs the greedy policy.
    The video holds the frame after the reset and one per step."""
    env.reset(is_training=False)
    rendered = env.render(mode="rgb_array")

    video_recorder = None
    if video_filename is not None and rendered is not None:
        video_recorder = VideoRecorder(
            video_filename, frame_size=rendered.shape, fps=getattr(env, "average_fps", 30))
        video_recorder.add_frame(rendered)

    total_reward = 0.0
    for _ in range(max_steps):
        action, value = predict_fn(env)
        obs, reward, done, info = env.step(np.asarray(action))
        if info.get("closed"):
            break
        env.extra_info.append("Eval (greedy)")
        env.extra_info.append("Value:  % 20.2f" % value)
        total_reward += reward
        frame = env.render(mode="rgb_array")
        if video_recorder is not None and frame is not None:
            video_recorder.add_frame(frame)
        if done:
            break

    if video_recorder is not None:
        video_recorder.release()
    return total_reward
