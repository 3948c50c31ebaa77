"""update_forward_ms.pixel_train: device ms of the kernels launched inside the program's `update.loss` range, the loss forward (the joint model on the minibatch frames, the PPO and VAE losses), mean per minibatch update, in one traced iteration after the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms(run, "update.loss")
