"""rollout_ms.train: ms of one iteration's rollout call (ppo.rollout with the frozen-VAE encode) between CUDA events, mean over the window."""


def read(run):
    return run.span_mean_ms("rollout")
