"""rollout_ms.pixel_train: ms of one iteration's rollout call (pixels.pixel_rollout) between CUDA events, mean over the window."""


def read(run):
    return run.span_mean_ms("rollout")
