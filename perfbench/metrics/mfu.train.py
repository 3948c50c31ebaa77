"""mfu.train: the model FLOPs of the window's iterations (recomputation not counted) over the window's seconds x 67 TFLOP/s of float32 x the cards, in %."""

from perfbench.harness import readers


def read(run):
    return readers.mfu_pct(run)
