"""policy_step_ms.seq_train: device ms of the kernels launched inside the program's `policy.step` ranges (the memory policy's step form: the torso's products, the state-space step kernel, the attention step), mean per call (the rollout's steps and its bootstrap value), in one traced iteration after the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms(run, "policy.step")
