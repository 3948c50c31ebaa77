"""env_step_launches.train: kernel launches inside the program's `env_step` ranges (dynamics, rewards, termination, auto-reset) per call, in one traced iteration after the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.launches_per_call(run, ["env_step"], "env_step")
