"""update_ms.pixel_train: ms of one iteration's update call (pixels.pixel_update: GAE and every update of the joint loss) between CUDA events, mean over the window."""


def read(run):
    return run.span_mean_ms("update")
