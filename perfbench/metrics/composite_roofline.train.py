"""composite_roofline.train: the least time of the traced iteration's composite calls (the frozen composite_ops and bound of the candidate rows they drew) over the composite kernels' device time, in %."""

from perfbench.harness import readers


def read(run):
    return readers.roofline_pct(run, "composite", "composite_kernel", readers.composite_bound)
