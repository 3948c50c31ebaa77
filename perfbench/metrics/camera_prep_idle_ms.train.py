"""camera_prep_idle_ms.train: per rendered batch, the ms inside the program's `camera.prep_windows` and `camera.prep_candidates` ranges in which the card ran nothing (no kernel, copy or set, whatever was queued before), in one traced iteration after the window."""

from perfbench.harness import program_spans

PREP = ["camera.prep_windows", "camera.prep_candidates"]


def read(run):
    return program_spans.idle_ms_per_call(run, PREP, "camera.prep_windows")
