"""Build the port's CUDA kernels with plain `nvcc` and load them with ctypes.

The sources in `carla_ppo_tpu_torch/csrc/*.cu` export `extern "C"`
launchers over raw pointers; they include no PyTorch header, so each file
compiles in seconds. The build runs at first use:

- into `<repo>/build/cuda/<hash>/` (git-ignored), where the hash covers the
  sources, the headers they include and the flags, so an edited source or
  header never loads a stale library;
- one `nvcc -c` per source, all started together, then one link;
- each process compiles in its own `tmp-<pid>` directory and publishes the
  library with an atomic rename, so there is no lock file to wait on; a
  leftover partial build (a `tmp-<pid>` whose process is gone) is deleted.

No `torch.utils.cpp_extension`, no ninja.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "cuda"
LIB_NAME = "libcarla_ppo_torch_kernels.so"
SOURCES = ("ground_pass.cu", "ground_pass_pose.cu", "composite.cu", "ssm_step.cu", "vae_encode.cu")
HEADERS = ("ground_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    candidates = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)
    ]
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def compile_commands(nvcc: str, out_dir: Path) -> tuple[list[list[str]], list[str]]:
    """(one compile command per source, the link command)."""
    objs = [out_dir / (Path(s).stem + ".o") for s in SOURCES]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
        for s, o in zip(SOURCES, objs)
    ]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-Xcompiler", "-fPIC", *map(str, objs), "-o", str(out_dir / LIB_NAME)]
    return compiles, link


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _remove_stale(build_dir: Path) -> None:
    for d in build_dir.glob("tmp-*"):
        pid = d.name.split("-", 1)[1]
        if not pid.isdigit() or not _pid_alive(int(pid)):
            shutil.rmtree(d, ignore_errors=True)


def _run_all(cmds: list[list[str]]) -> None:
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    failures = []
    for cmd, p in zip(cmds, procs):
        try:
            out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s: {' '.join(cmd)}")
        print(f"[cuda_build] {' '.join(cmd)}\n{out.strip()}", flush=True)
        if p.returncode != 0:
            failures.append((cmd, p.returncode))
    if failures:
        raise RuntimeError(f"nvcc failed: {failures}")


def build() -> Path:
    """Build (or find) the kernel library; returns its path."""
    build_dir = BUILD_ROOT / source_hash()
    lib = build_dir / LIB_NAME
    build_dir.mkdir(parents=True, exist_ok=True)
    _remove_stale(build_dir)
    if lib.exists():
        return lib
    tmp = build_dir / f"tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    try:
        t0 = time.perf_counter()
        compiles, link = compile_commands(find_nvcc(), tmp)
        _run_all(compiles)
        _run_all([link])
        os.replace(tmp / LIB_NAME, lib)
        print(f"[cuda_build] built {lib} in {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every launcher's signature."""
    lib = ctypes.CDLL(str(build()))
    lib.launch_ground_pass.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _F, _F, _F, _F, _F, _F, _F, _F, _P, _P]
    lib.launch_ground_pass.restype = _I
    lib.launch_ground_pass_pose.argtypes = [_P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                            _F, _F, _F, _F, _F, _F, _F, _F, _P, _P]
    lib.launch_ground_pass_pose.restype = _I
    lib.launch_composite.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P]
    lib.launch_composite.restype = _I
    lib.launch_composite_depth_sky.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
    lib.launch_composite_depth_sky.restype = _I
    lib.launch_ssm_step.argtypes = [_P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                    _P, _P]
    lib.launch_ssm_step.restype = _I
    lib.launch_vae_encode.argtypes = [_P, _I, _I] + [_P] * 14
    lib.launch_vae_encode.restype = _I
    return lib
