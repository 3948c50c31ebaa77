"""camera_prep_launches.train: kernel launches inside the program's `camera.prep_windows` and `camera.prep_candidates` ranges per rendered batch, in one traced iteration after the window."""

from perfbench.harness import program_spans

PREP = ["camera.prep_windows", "camera.prep_candidates"]


def read(run):
    return program_spans.launches_per_call(run, PREP, "camera.prep_windows")
