"""ground_pass_roofline.train: the least time of the traced iteration's ground-pass calls (the frozen ground_ops and bound of the inputs they rendered) over the ground-pass kernels' device time, in %."""

from perfbench.harness import readers


def read(run):
    return readers.roofline_pct(run, "ground_pass", "ground_pass_kernel", readers.ground_pass_bound)
