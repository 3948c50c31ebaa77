"""The benchmark fails, and prints no result, without a card or without
the program beside it; it never falls back to the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def result_lines(stdout: str):
    out = []
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                out.append(line)
        except ValueError:
            pass
    return out


def test_run_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "lap_latent_seg.train",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not result_lines(out.stdout), out.stdout
    assert "CUDA" in out.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, the
    program is missing: the run fails before any result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from perfbench.harness.main import run_cell\n"
            "print(run_cell('lap_latent_seg.train', 1, 0.0, False, time.perf_counter(), device='cpu'))\n"
            % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "carla_ppo_tpu_torch" in out.stderr
    assert not result_lines(out.stdout)
