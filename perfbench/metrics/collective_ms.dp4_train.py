"""collective_ms.dp4_train: device ms of the kernels launched inside the program's `dp.mean` ranges on rank 0 (the all-reduces of the update: gradients and minibatch metrics, advantage moments, episodic metrics; an NCCL kernel's time holds its wait for the other ranks), per minibatch update (per call of `update.loss`), in one traced iteration after the window."""

from perfbench.harness import program_spans


def read(run):
    r = program_spans.readings(run)
    mean = r.range("dp.mean") if r is not None else None
    loss = r.range("update.loss") if r is not None else None
    if mean is None or loss is None:
        return None
    return mean.device_ms / loss.calls
