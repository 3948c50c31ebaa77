"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # perfbench/
ROOT = os.path.dirname(HERE)
JAX = {"jax", "jaxlib", "flax", "carla_ppo_tpu"}


def sources(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p for p in sources(HERE) if "/tests/" not in p))
def test_no_source_imports_jax(path):
    assert not set(imported_tops(path)) & JAX, path


@pytest.mark.parametrize("path", sorted(sources(os.path.join(HERE, "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert "carla_ppo_tpu_torch" not in tops and not tops & JAX, path


def test_loaded_modules_hold_no_jax():
    """Import the harness, every driver and metric reader and the reference,
    and drive the latent cell's program set-up at a tiny size on the CPU;
    then no module whose top-level name is a JAX one is loaded."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from perfbench.harness.main import run_cell, forbidden_modules\n"
        "from perfbench.harness import manifest as M\n"
        "for w in M.load_manifest()['workloads']: M.Cell(w['name']).readers()\n"
        "ov = {'config': {'ppo': {'num_envs': 4, 'horizon': 2, 'num_minibatches': 2}}}\n"
        "run_cell('lap_latent_seg.train', 7, 0.0, False, time.perf_counter(), device='cpu', overrides=ov)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & %r)); print(forbidden_modules())\n" % (ROOT, JAX))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-2:] == ["[]", "[]"], out.stdout


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.latent_ppo, perfbench.reference.pixel_ppo\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'carla_ppo_tpu_torch', 'carla_ppo_tpu', 'jax'}))\n"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
