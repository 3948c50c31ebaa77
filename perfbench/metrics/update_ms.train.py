"""update_ms.train: ms of one iteration's update call (ppo.update_from_rollout: GAE and every Adam update) between CUDA events, mean over the window."""


def read(run):
    return run.span_mean_ms("update")
