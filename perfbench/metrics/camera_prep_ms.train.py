"""camera_prep_ms.train: ms of the camera prep of one rendered batch (rasterizer.prep_windows + prep_candidates, each between CUDA events, means per call summed)."""

from perfbench.harness import readers


def read(run):
    return readers.summed_means_ms(run, ("prep_windows", "prep_candidates"))
