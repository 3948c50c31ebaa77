"""mfu.seq_train: the model FLOPs of the window's memory-policy iterations (harness/yardstick_seq.py; the backward's recomputation not counted) over the window's seconds x 67 TFLOP/s of float32 x the cards, in %."""

from perfbench.harness import readers


def read(run):
    return readers.mfu_pct(run)
