"""env_step_idle_ms.train: per env step, the ms inside the program's `env_step` range in which the card ran nothing (no kernel, copy or set, whatever was queued before), in one traced iteration after the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.idle_ms_per_call(run, ["env_step"], "env_step")
