"""update_adam_ms.pixel_train: device ms of the kernels launched inside the program's `update.adam` range, both groups' clip and Adam steps with the parameter copy, mean per minibatch update, in one traced iteration after the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms(run, "update.adam")
