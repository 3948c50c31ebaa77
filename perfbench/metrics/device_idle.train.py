"""device_idle.train: the share of the window's mean iteration with no kernel, copy or set running on the card (the traced iteration's device busy time over the window's seconds per iteration), in %."""

from perfbench.harness import readers


def read(run):
    return readers.device_idle_pct(run)
