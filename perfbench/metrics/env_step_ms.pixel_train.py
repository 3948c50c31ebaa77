"""env_step_ms.pixel_train: ms of one lap_env.autoreset_step call (dynamics, rewards, termination, auto-reset) between CUDA events, mean over the window."""


def read(run):
    return run.span_mean_ms("env_step")
