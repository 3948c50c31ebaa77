"""ssm_step_roofline.seq_train: the state-space step kernel's least time by bytes (the state of each env that does not start an episode read, every state written where the call commits, and its small inputs and output, at 3.35 TB/s) over its device time, summed over the traced block's calls, in %."""

from perfbench.harness import readers, yardstick_seq


def read(run):
    return readers.roofline_pct(run, "ssm_step", "ssm_step_kernel", yardstick_seq.ssm_step_bound_ms)
