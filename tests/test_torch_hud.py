"""The port's HUD overlay (carla_ppo_tpu_torch/envs/hud.py): the four cases
of tests/test_hud.py on the port's classes, and one HUD frame drawn by the
port from a batch-of-one state against the JAX package's HUD drawn from
the same values unbatched: pixel for pixel equal (the same fonts, layout
and text; headless pygame)."""

from __future__ import annotations

import os

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

import time

import numpy as np
import pytest
import torch

pygame = pytest.importorskip("pygame")

from carla_ppo_tpu.envs import hud as jhud
from carla_ppo_tpu_torch.envs.hud import HUD, HelpPanel, NotificationStack


class _FakeEnv:
    """Just enough of CarlaLapEnv's surface for HUD.render/tick (unbatched
    numpy, as tests/test_hud.py builds it)."""

    class _S:
        class _V:
            speed = 5.0
            yaw = 0.25
            pos = np.array([12.0, -3.0])

        vehicle = _V()
        control = np.array([-0.4, 0.7])
        time = 42.0

    state = _S()
    fps = 30


class _FakeTorchEnv:
    """The same values as the port's envs hold them: a batch of one env."""

    class _S:
        class _V:
            speed = torch.tensor([5.0])
            yaw = torch.tensor([0.25])
            pos = torch.tensor([[12.0, -3.0]])

        vehicle = _V()
        control = torch.tensor([[-0.4, 0.7]])
        time = torch.tensor([42.0])

    state = _S()
    fps = 30


class _Clock:
    def get_fps(self):
        return 29.7


@pytest.fixture(scope="module")
def display():
    pygame.init()
    pygame.font.init()
    surf = pygame.display.set_mode((320, 240))
    yield surf
    pygame.quit()


def _nonblack_pixels(surface) -> int:
    arr = pygame.surfarray.array3d(surface)
    return int((arr.sum(axis=2) > 0).sum())


def test_render_with_gauges(display):
    display.fill((0, 0, 0))
    hud = HUD(320, 240)
    hud.tick(_FakeTorchEnv(), pygame.time.Clock())
    hud.render(display, _FakeTorchEnv(), extra_info=["Reward: 1.00"])
    assert _nonblack_pixels(display) > 500


def test_gauge_bipolar_direction(display):
    hud = HUD(320, 240)
    line_h = hud._font_mono.get_linesize()

    def fill_columns(value, bipolar):
        display.fill((0, 0, 0))
        hud._draw_gauge(display, "Steer", value, bipolar, 0, line_h)
        arr = pygame.surfarray.array3d(display)
        bar_x = hud.PANEL_PAD + hud._font_mono.size("Throttle -0.00  ")[0]
        band = arr[bar_x: bar_x + hud.GAUGE_W, : line_h + hud.GAUGE_H].sum(axis=(1, 2))
        return band > band.max() * 0.6

    mid = hud.GAUGE_W // 2
    left = fill_columns(-1.0, True)
    right = fill_columns(1.0, True)
    assert left[: mid - 2].sum() > right[: mid - 2].sum()
    assert right[mid + 2:].sum() > left[mid + 2:].sum()
    assert fill_columns(0.9, False).sum() > fill_columns(0.1, False).sum()


def test_help_panel_toggle(display):
    display.fill((0, 0, 0))
    font = pygame.font.Font(pygame.font.get_default_font(), 18)
    panel = HelpPanel(font, (320, 240))
    panel.render(display)
    assert _nonblack_pixels(display) == 0  # hidden by default
    panel.toggle()
    panel.render(display)
    assert _nonblack_pixels(display) > 200
    panel.toggle()
    assert not panel.visible


def test_notification_stack_fades():
    pygame.init()
    pygame.font.init()
    font = pygame.font.Font(pygame.font.get_default_font(), 18)
    stack = NotificationStack(font, (320, 240), fade_window=0.5)
    stack.push("hello", seconds=0.01)
    stack.push("world", seconds=60.0)
    time.sleep(0.05)
    stack.prune()
    assert [m[0] for m in stack._messages] == ["world"]


def test_hud_frame_equals_jax(display):
    """The same telemetry, extra lines, help panel and a notification: the
    port's frame equals the JAX HUD's pixel for pixel."""
    frames = []
    for cls, env in ((jhud.HUD, _FakeEnv()), (HUD, _FakeTorchEnv())):
        display.fill((30, 60, 90))
        hud = cls(320, 240)
        hud.tick(env, _Clock())
        hud.help.toggle()
        hud.notification("Collision with roadside", seconds=60.0)
        hud.render(display, env, extra_info=["Reward:  1.25", "", "Maneuver:  Follow Lane"])
        frames.append(pygame.surfarray.array3d(display).copy())
    assert _nonblack_pixels(display) > 500
    np.testing.assert_array_equal(frames[1], frames[0])
