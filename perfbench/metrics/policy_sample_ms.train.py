"""policy_sample_ms.train: host ms of the program's `policy.sample` span (the policy's forward and the action draw, a host-bound layer timed on the host clock), mean per call, in one iteration recorded after the window."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.host_ms(run, "policy.sample")
