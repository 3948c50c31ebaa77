"""rollout_skew_ms.dp4_train: the largest minus the least, over the ranks, of the host ms of the program's `rollout` span in one more iteration after the window, every rank recording its spans (the time the faster ranks then wait in the update's first all-reduce)."""


def read(run):
    skew = getattr(run.driver, "rollout_skew_ms", None)
    return None if skew is None else skew()
