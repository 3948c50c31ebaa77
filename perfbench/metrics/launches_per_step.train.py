"""launches_per_step.train: kernel launches the host made in the traced iteration's rollout, per rollout step (the currency of the host bound)."""

from perfbench.harness import readers


def read(run):
    return readers.launches_per_step(run, "perfbench.rollout", run.driver.rollout_steps)
