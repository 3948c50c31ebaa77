"""The inspection CLIs (cli/inspect_vae, inspect_agent, vae_plots) against
the JAX package's, and the last converted VAE.

The JAX side loads the shipped VAEs from vae/models and the shipped latent
agent (models/latent_agent_pretrained); the port loads their conversions
under models/torch. Both run on the CPU on the same numpy inputs.
Tolerances:
- float decoder outputs (generate_from_latent, reconstruct, the plot
  arrays) and the agent's steer, throttle and value: within 1e-4 (the
  converted weights' tolerance, tests/test_torch_checkpoints.py);
- uint8 images (decode_image, the contact sheet, the windows' images):
  within 1 level on every pixel but at most 0.1% of them, which may
  differ more only where a seg output's class flips at a rounding
  boundary; seg classes equal on at least 99.9% of pixels;
- the printed --dump lines: the same text but for the last printed digit.
The windows run under tests/torch_tk_stub.py, a recording stand-in for
tkinter and PIL.ImageTk, driven by the same callback script on each side.
"""

from __future__ import annotations

import os
import re

import matplotlib
import matplotlib.axes
import numpy as np
import pytest
import torch
from PIL import Image

from carla_ppo_tpu.cli import inspect_agent as j_inspect_agent
from carla_ppo_tpu.cli import inspect_vae as j_inspect_vae
from carla_ppo_tpu.cli import vae_plots as j_vae_plots
from carla_ppo_tpu.models import vae_common as j_vae_common
from carla_ppo_tpu_torch.cli import inspect_agent, inspect_vae, vae_plots
from carla_ppo_tpu_torch.models import vae_common
from carla_ppo_tpu_torch.utils.datasets import load_images, preprocess_rgb_frame
from carla_ppo_tpu_torch.utils.png import write_png
from tests import torch_tk_stub
from tests.test_torch_common import REPO

matplotlib.use("Agg")

DEPROP = "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data"  # 1 -> 1 channel
RGB = "rgb_bce_cnn_zdim64_beta1_kl_tolerance0.0_data"  # 3 -> 3 channels
LAST = "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_data"  # converted last
TOL = 1e-4
MAX_OFF_SHARE = 1e-3  # pixels more than 1 level off (seg class flips)


def jax_dir(name):
    return str(REPO / "vae" / "models" / name)


def port_dir(name):
    return str(REPO / "models" / "torch" / "vae_models" / name)


@pytest.fixture(scope="module")
def vaes():
    """{name: ((JAX model, variables), port model on the CPU)}, loaded once."""
    return {name: (j_vae_common.load_vae(jax_dir(name)),
                   vae_common.load_vae(port_dir(name), device="cpu"))
            for name in (DEPROP, RGB)}


def assert_images_close(got: np.ndarray, want: np.ndarray, seg: bool) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    off = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1) > 1
    if seg:
        assert off.mean() <= MAX_OFF_SHARE, off.mean()
    else:
        assert not off.any(), int(off.sum())


def layout(tk):
    """Each widget's kind, static options and grid place, in creation order."""
    return [(w.kind, {k: v for k, v in w.options.items() if k not in ("command", "image", "text")
                      or w.kind == "Button" and k == "text"}, w.grid_options) for w in tk.widgets]


def seeded_z(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 64)).astype(np.float32)


@pytest.mark.parametrize("name", [DEPROP, RGB], ids=["seg", "rgb"])
def test_decode_image_matches_jax(vaes, name):
    (jm, jv), pm = vaes[name]
    z = seeded_z(4)
    want = np.asarray(jm.apply(jv, z, method=jm.generate_from_latent))
    with torch.no_grad():
        got = pm.generate_from_latent(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    seg = pm.out_shape[-1] == 1
    for row in z[:2]:
        a, b = inspect_vae.decode_image(pm, row), j_inspect_vae.decode_image(jm, jv, row)
        assert a.shape == (80, 160, 3)
        assert_images_close(a, b, seg)
    if seg:
        classes = [np.clip(np.round(x[..., 0] * 12.0), 0, 12) for x in (got, want)]
        assert (classes[0] == classes[1]).mean() >= 0.999


@pytest.mark.parametrize("name", [DEPROP, RGB], ids=["seg", "rgb"])
def test_dump_sweep_matches_jax(vaes, name, tmp_path):
    (jm, jv), pm = vaes[name]
    j_inspect_vae.dump_sweep(jm, jv, str(tmp_path / "j.png"), dims=2, steps=3)
    inspect_vae.dump_sweep(pm, str(tmp_path / "p.png"), dims=2, steps=3)
    got, want = (np.asarray(Image.open(tmp_path / f)) for f in ("p.png", "j.png"))
    assert got.shape == (2 * 80, 3 * 160, 3)
    assert_images_close(got, want, pm.out_shape[-1] == 1)


_LINE = re.compile(r"  z=([+-]\d\.\d): steer=([+-]\d\.\d{3}) throttle=(\d\.\d{3}) value=(-?\d+\.\d{2})$")


def test_inspect_agent_dump_matches_jax(monkeypatch, capsys):
    """`--dump` of the converted latent agent (torch/latent_agent, step
    1450) against JAX's latent_agent_pretrained with the de-prop VAE."""
    monkeypatch.chdir(REPO)
    j_inspect_agent.main(["--model_name", "latent_agent_pretrained", "--vae_model", jax_dir(DEPROP),
                          "--dump"])
    want_text = capsys.readouterr().out.strip().splitlines()
    rows = inspect_agent.main(["--model_name", "torch/latent_agent", "--vae_model", port_dir(DEPROP),
                               "--dump", "--device", "cpu"])
    got_text = capsys.readouterr().out.strip().splitlines()

    # The raw numbers: JAX's policy at the same observations.
    model, params = j_inspect_agent.load_agent("latent_agent_pretrained", 67)
    z = np.zeros((13, 64), np.float32)
    z[:, 0] = np.linspace(-3, 3, 13)
    obs = np.concatenate([z, np.tile(np.float32([0.0, 0.5, 5.0]), (13, 1))], 1)
    mean, _, value = (np.asarray(x) for x in model.apply(params, obs))
    got = np.array(rows)
    assert got.shape == (13, 4)
    np.testing.assert_array_equal(got[:, 0], np.linspace(-3, 3, 13))
    np.testing.assert_allclose(got[:, 1:3], mean, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[:, 3], value, rtol=0, atol=TOL)

    assert len(got_text) == len(want_text) == 14 and got_text[0] == want_text[0]
    for g, w in zip(got_text[1:], want_text[1:]):
        gm, wm = _LINE.match(g), _LINE.match(w)
        assert gm and wm, (g, w)
        assert gm.group(1) == wm.group(1)
        for k, unit in ((2, 1e-3), (3, 1e-3), (4, 1e-2)):
            assert abs(float(gm.group(k)) - float(wm.group(k))) <= unit * 1.01, (g, w)


def _write_frames(folder, n=4, seed=0):
    """`n` seeded 80x160 RGB PNGs laid out as collect_data writes them."""
    rgb = folder / "rgb"
    rgb.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 10, 20, 3), dtype=np.uint8)
    for i, img in enumerate(base):
        write_png(str(rgb / f"{i}.png"), np.repeat(np.repeat(img, 8, 0), 8, 1))
    return folder


@pytest.mark.parametrize("name, with_dataset", [(RGB, True), (DEPROP, False)],
                         ids=["rgb+reconstructions", "seg"])
def test_vae_plots_matches_jax(name, with_dataset, tmp_path, monkeypatch):
    """main on both sides with Axes.imshow capturing what each draws."""
    shown = []
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow",
                        lambda self, x, *a, **k: shown.append(np.asarray(x)))
    extra = ["--dataset", str(_write_frames(tmp_path / "data"))] if with_dataset else []
    j_vae_plots.main(["--model_dir", jax_dir(name), "--out_dir", str(tmp_path / "j"),
                      "--dims", "2", "--steps", "3", *extra])
    want, shown[:] = list(shown), []
    vae_plots.main(["--model_dir", port_dir(name), "--out_dir", str(tmp_path / "p"),
                    "--dims", "2", "--steps", "3", "--device", "cpu", *extra])
    got = list(shown)
    assert len(got) == len(want) == 6 + (2 * 4 if with_dataset else 0)
    seg = name == DEPROP
    for g, w in zip(got, want):
        assert g.shape == w.shape == (80, 160, 3)
        if seg:
            assert (np.abs(g - w).max(-1) <= TOL).mean() >= 0.999
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    files = ["latent_sweep.png"] + (["reconstructions.png"] if with_dataset else [])
    for side in ("j", "p"):
        assert sorted(os.listdir(tmp_path / side)) == files


def test_inspect_vae_ui_matches_jax(vaes, tmp_path):
    """run_ui of the RGB VAE on both sides: refresh, a latent slider,
    Reset, and "Set z by image" after the same np.random.seed."""
    (jm, jv), pm = vaes[RGB]
    source = str(_write_frames(tmp_path / "data", n=5) / "rgb")

    def drive(run):
        with torch_tk_stub.installed() as tk:
            run()
            tk.scale("z3").command("1.5")
            tk.button("Reset").command()
            np.random.seed(7)
            tk.button("Set z by image").command()
        return tk

    jtk = drive(lambda: j_inspect_vae.run_ui(jm, jv, source))
    ptk = drive(lambda: inspect_vae.run_ui(pm, source))
    assert layout(ptk) == layout(jtk)
    assert len([w for w in ptk.widgets if w.kind == "Scale"]) == 32
    assert [w.looped for w in ptk.windows] == [1]
    assert len(ptk.images) == len(jtk.images) == 4
    for g, w in zip(ptk.images, jtk.images):
        assert g.shape == (240, 480, 3)
        assert_images_close(g, w, seg=False)
    got_z = np.array([ptk.scale(f"z{d}").value for d in range(32)])
    want_z = np.array([jtk.scale(f"z{d}").value for d in range(32)])
    np.testing.assert_allclose(got_z, want_z, rtol=0, atol=TOL)
    # Each image is decode_image of the z the script set.
    frames = load_images(source, preprocess_rgb_frame, limit=50)
    np.random.seed(7)
    with torch.no_grad():
        seeded = pm.encode(torch.as_tensor(frames[np.random.randint(len(frames))][None]))[0].numpy()
    one = np.zeros(64, np.float32)
    one[3] = 1.5
    for img, z in zip(ptk.images, [np.zeros(64, np.float32), one, np.zeros(64, np.float32), seeded]):
        np.testing.assert_array_equal(img[::3, ::3], inspect_vae.decode_image(pm, z))


def test_inspect_agent_ui_matches_jax(monkeypatch):
    """The agent window on both sides: a latent and a speed slider; the
    images and the action label after each."""
    monkeypatch.chdir(REPO)

    def drive(main, argv):
        with torch_tk_stub.installed() as tk:
            main(argv)
            tk.scale("z2").command("1.0")
            tk.scale("speed").command("12.0")
        return tk

    jtk = drive(j_inspect_agent.main, ["--model_name", "latent_agent_pretrained",
                                       "--vae_model", jax_dir(DEPROP)])
    ptk = drive(inspect_agent.main, ["--model_name", "torch/latent_agent",
                                     "--vae_model", port_dir(DEPROP), "--device", "cpu"])
    assert layout(ptk) == layout(jtk)
    assert len([w for w in ptk.widgets if w.kind == "Scale"]) == 24 + 3
    assert [w.looped for w in ptk.windows] == [1]
    assert [ptk.scale(n).value for n in ("steer", "throttle", "speed")] == [0.0, 0.5, 5.0]
    assert len(ptk.images) == len(jtk.images) == 3
    for g, w in zip(ptk.images, jtk.images):
        assert_images_close(g, w, seg=True)
    label = [w for w in ptk.labels() if "font" in w.options][0].options["text"]
    want = [w for w in jtk.labels() if "font" in w.options][0].options["text"]
    nums = [[float(x) for x in re.findall(r"[+-]?\d+\.\d+", t)] for t in (label, want)]
    np.testing.assert_allclose(nums[0], nums[1], rtol=0, atol=0.0101)
    assert label.splitlines()[0].startswith("steer    ")


def test_last_vae_conversion_matches_jax():
    """The converted from_seg_seg_..._data VAE (no key in the pinned
    goldens) against JAX's load_vae of the shipped one: the encode of a
    seeded 1-channel frame and the decode of that latent, within 1e-4."""
    jm, jv = j_vae_common.load_vae(jax_dir(LAST))
    pm = vae_common.load_vae(port_dir(LAST), device="cpu")
    assert pm.source_shape == (80, 160, 1) and pm.out_shape == (80, 160, 1)
    frame = (np.random.default_rng(3).integers(0, 13, (2, 80, 160, 1)) / 12.0).astype(np.float32)
    want_z = np.asarray(jm.apply(jv, frame, method=jm.encode))
    with torch.no_grad():
        got_z = pm.encode(torch.from_numpy(frame))
        got_img = pm.generate_from_latent(got_z).numpy()
    np.testing.assert_allclose(got_z.numpy(), want_z, rtol=0, atol=TOL)
    want_img = np.asarray(jm.apply(jv, want_z, method=jm.generate_from_latent))
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=TOL)
