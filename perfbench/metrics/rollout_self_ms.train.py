"""rollout_self_ms.train: host ms of the program's `rollout` span outside its child spans (the rollout's own bookkeeping: appends, casts, stacks, the bootstrap value), per rollout step, in one iteration recorded after the window."""

from perfbench.harness import program_spans


def read(run):
    r = program_spans.readings(run)
    t = r.spans.get("rollout") if r is not None else None
    return t.host_self_ms / (t.calls * run.driver.rollout_steps) if t is not None and t.calls else None
