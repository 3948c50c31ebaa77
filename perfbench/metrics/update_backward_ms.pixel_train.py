"""update_backward_ms.pixel_train: device ms of the kernels launched inside the program's `update.backward` range, loss.backward() (with the encoder and decoder recomputed), mean per minibatch update, in one traced iteration after the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms(run, "update.backward")
