"""Shared helpers of the tests/test_torch_*.py parity tests, and the port's
structural tests.

The helpers carry JAX pytrees (tracks, env states, parameter trees) across
to the PyTorch port as numpy arrays. The tests pin
what the port must never do (import JAX or the JAX package), the kernels'
build contract, and the wrappers' refusal of CPU tensors.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from carla_ppo_tpu_torch.envs.track import track_from_arrays
from carla_ppo_tpu_torch.envs.types import EnvParams as TEnvParams
from carla_ppo_tpu_torch.utils.convert import env_state_from_arrays, light_table

REPO = pathlib.Path(__file__).resolve().parent.parent


def np_tree(tree):
    """A JAX pytree as nested dicts / leaves of numpy arrays."""
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_track(jtrack, device="cpu"):
    arrays = np_tree(jtrack)
    arrays["length"] = int(arrays["length"])
    arrays["is_loop"] = bool(arrays["is_loop"])
    return track_from_arrays(arrays, device)


def port_params(jparams, device="cpu", **overrides):
    """Port EnvParams on the same track with the same traffic-light table
    (other fields at the shared defaults unless overridden)."""
    lights = light_table({k: getattr(jparams, k) for k in (
        "light_wp", "light_phase", "light_period", "light_green_frac", "light_yellow_frac")}, device)
    return TEnvParams(track=port_track(jparams.track, device), **{**lights, **overrides})


def port_state(jstate, device="cpu"):
    return env_state_from_arrays(np_tree(jstate), device)


# ---------------------------------------------------------------------------


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|orbax|chex|carla_ppo_tpu)(\s|\.|$)", re.M
)


# tests/torch_tk_stub.py is imported by chip_smoke.py on the card's machine.
@pytest.mark.parametrize("path", ["carla_ppo_tpu_torch", "chip_smoke.py",
                                  "tests/torch_tk_stub.py"])
def test_port_imports_no_jax(path):
    """The port and its chip smoke import neither JAX nor the JAX package."""
    root = REPO / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_kernel_build_flags():
    """Plain nvcc for sm_90a with -fmad=false (bit-exact against the plain
    versions), one compile per source plus one link, no torch headers; each
    source names the TPU kernel it replaces, or that it replaces none (the
    memory policy's SSM step)."""
    from carla_ppo_tpu_torch.utils import cuda_build

    compiles, link = cuda_build.compile_commands("nvcc", pathlib.Path("/tmp/x"))
    assert len(compiles) == len(cuda_build.SOURCES) == 4
    for cmd in compiles:
        assert "-fmad=false" in cmd and "arch=compute_90a,code=sm_90a" in cmd
        assert "-c" in cmd and "-Xptxas" in cmd
    assert "-shared" in link
    for src in cuda_build.SOURCES:
        text = (cuda_build.CSRC / src).read_text()
        assert 'extern "C"' in text and "torch/" not in text
        head = text.split("#include")[0]
        if src == "ssm_step.cu":
            assert "Replaces: no TPU kernel" in head
        else:
            assert "rasterizer_pallas.py" in head


def test_kernel_hash_tracks_sources():
    from carla_ppo_tpu_torch.utils import cuda_build

    h = cuda_build.source_hash()
    assert len(h) == 16 and h == cuda_build.source_hash()


def test_kernel_hash_tracks_header(tmp_path):
    """An edit to the shared header gives a new build directory, so no
    stale library is loaded."""
    import shutil

    from carla_ppo_tpu_torch.utils import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    before = cuda_build.source_hash(csrc)
    assert before == cuda_build.source_hash()
    header = csrc / "ground_common.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert cuda_build.source_hash(csrc) != before
    assert '#include "ground_common.cuh"' in (csrc / "ground_pass.cu").read_text()
    assert '#include "ground_common.cuh"' in (csrc / "ground_pass_pose.cu").read_text()


_NETWORKX = re.compile(r"^\s*(import|from)\s+networkx(\s|\.|$)", re.M)


# tests/torch_tk_stub.py is imported by chip_smoke.py on the card's machine.
@pytest.mark.parametrize("path", ["carla_ppo_tpu_torch", "chip_smoke.py",
                                  "tests/torch_tk_stub.py"])
def test_port_imports_no_networkx(path):
    """The card's machine has no networkx: the port plans routes without it."""
    root = REPO / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    assert files
    assert [str(f) for f in files if _NETWORKX.search(f.read_text())] == []


@pytest.mark.parametrize("kernel", ["ground_pass", "composite", "ground_pass_pose",
                                    "composite_depth_sky"])
def test_cuda_wrappers_refuse_cpu_tensors(kernel):
    """A kernel wrapper launches on CUDA tensors or raises; it never falls
    back to the plain version."""
    from carla_ppo_tpu_torch.ops import rasterizer_cuda as RC

    before = dict(RC.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "ground_pass":
            RC.ground_pass_cuda(
                torch.zeros(8, 128, 8), torch.zeros(8, 8, 128), torch.zeros(2, 6400),
                torch.zeros(5, 3, dtype=torch.int32), 6400, 12800, (0.0,) * 8,
            )
        elif kernel in ("composite", "composite_depth_sky"):
            fn = RC.composite_cuda if kernel == "composite" else RC.composite_depth_sky_cuda
            fn(torch.zeros(8, 72, 8), torch.zeros(80), torch.zeros(8, 12800, dtype=torch.int32), 160)
        else:
            RC.ground_pass_pose_cuda(
                torch.zeros(8, dtype=torch.int32), torch.zeros(1200, 8), torch.zeros(8, 8), 128,
                torch.zeros(2, 6400), torch.zeros(5, 3, dtype=torch.int32), 6400, 12800, (0.0,) * 8,
            )
    assert RC.LAUNCHES == before


def test_entry_points_default_to_cuda():
    """Without a card, the default device raises instead of falling back."""
    from carla_ppo_tpu_torch.cli import inspect_vae
    from carla_ppo_tpu_torch.envs import gym_api, track
    from carla_ppo_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        track.make_lap_track(seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        gym_api.CarlaLapEnv()
    with pytest.raises(RuntimeError, match="cuda"):
        inspect_vae.main(["--model_dir", str(REPO / "models" / "torch" / "vae_models"
                                             / "rgb_bce_cnn_zdim64_beta1_kl_tolerance0.0_data"),
                          "--dump", "unwritten.png"])
    assert resolve_device("cpu").type == "cpu"


def test_convert_layouts():
    """Dense [in,out] -> [out,in]; Conv HWIO -> OIHW; NHWC-flatten rows ->
    NCHW-flatten rows (checked against an explicit loop)."""
    from carla_ppo_tpu_torch.utils import convert

    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 5)).astype(np.float32)
    w, b = convert.dense(k, np.zeros(5, np.float32))
    np.testing.assert_array_equal(w.numpy(), k.T)
    assert b.shape == (5,)
    conv = rng.normal(size=(4, 4, 2, 7)).astype(np.float32)
    np.testing.assert_array_equal(convert.conv_hwio_to_oihw(conv).numpy()[6, 1, 2, 3], conv[2, 3, 1, 6])
    h, wd, c = 2, 3, 4
    kern = rng.normal(size=(h * wd * c, 6)).astype(np.float32)
    out = convert.nhwc_rows_to_nchw(kern, (h, wd, c))
    for i in range(h):
        for j in range(wd):
            for ch in range(c):
                np.testing.assert_array_equal(out[ch * h * wd + i * wd + j], kern[(i * wd + j) * c + ch])


def test_state_roundtrip(lap_params):
    """env_state_from_arrays / env_state_to_arrays carry a JAX batch across
    and back without loss."""
    from carla_ppo_tpu.envs import lap_env
    from carla_ppo_tpu_torch.utils.convert import env_state_to_arrays

    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    js = jax.vmap(lambda k: lap_env.reset(lap_params, k))(keys)
    back = env_state_to_arrays(port_state(js))
    ref = np_tree(js)
    np.testing.assert_array_equal(back["vehicle"]["pos"], ref["vehicle"]["pos"])
    for name in ("waypoint_idx", "npc_s", "is_training", "distance_from_center"):
        np.testing.assert_array_equal(back[name], ref[name])
