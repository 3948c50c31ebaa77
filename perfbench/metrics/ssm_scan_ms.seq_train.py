"""ssm_scan_ms.seq_train: device ms of the kernels launched inside the program's `ssm.scan` ranges (the sequence form's chunked scan of every Mamba layer), per minibatch update (per call of `update.loss`), forward only (the backward's recomputation runs with the spans off), in one traced iteration after the window."""

from perfbench.harness import program_spans


def read(run):
    r = program_spans.readings(run)
    scan = r.range("ssm.scan") if r is not None else None
    loss = r.range("update.loss") if r is not None else None
    if scan is None or loss is None:
        return None
    return scan.device_ms / loss.calls
