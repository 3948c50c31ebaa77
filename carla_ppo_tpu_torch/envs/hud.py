"""pygame HUD overlay for the interactive viewer (port of
carla_ppo_tpu/envs/hud.py, which imports no JAX: the same layout, fonts
and gauges).

Sim/client FPS, vehicle telemetry, transient notifications (collision /
lane invasion), and the env's `extra_info` lines (reward, maneuver, lap
progress...). Host-side only. pygame is imported inside the functions, so
the module imports where pygame is absent. The env's state is a batch of
one env (tensors of shape [1, ...], on any device); `_floats` reads it,
and also reads unbatched numpy values.

Original implementation: notifications are a time-stamped message *stack*
(newest at the bottom, several visible at once) whose text is re-rendered
each frame with an alpha computed from the message's remaining lifetime -
there is no persistent pre-blitted surface to fade. Layout is derived from
font metrics (line height, text width) instead of fixed pixel offsets.
"""

from __future__ import annotations

import datetime
import time
from typing import List, Tuple

import numpy as np


def _floats(x) -> List[float]:
    """The values of a tensor or array, flattened, as Python floats."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64).reshape(-1).tolist()


class NotificationStack:
    """Transient bottom-anchored messages with per-message fade-out.

    Each message carries its own absolute expiry; alpha ramps down linearly
    over the final `fade_window` seconds. Up to `max_visible` messages render
    at once, newest closest to the screen bottom.
    """

    def __init__(self, font, screen_size, fade_window=0.8, max_visible=3):
        self.font = font
        self.screen_w, self.screen_h = screen_size
        self.fade_window = fade_window
        self.max_visible = max_visible
        self._messages: List[Tuple[str, Tuple[int, int, int], float]] = []

    def push(self, text, color=(255, 255, 255), seconds=2.0):
        self._messages.append((text, color, time.monotonic() + seconds))

    def prune(self):
        now = time.monotonic()
        self._messages = [m for m in self._messages if m[2] > now]

    def render(self, display):
        self.prune()
        now = time.monotonic()
        line_h = self.font.get_linesize() + 6
        baseline = self.screen_h - line_h - 6
        for text, color, expiry in reversed(self._messages[-self.max_visible:]):
            remaining = expiry - now
            alpha = int(255 * min(1.0, remaining / self.fade_window))
            label = self.font.render(text, True, color)
            label.set_alpha(alpha)
            x = (self.screen_w - label.get_width()) // 2  # centered
            display.blit(label, (x, baseline))
            baseline -= line_h


class HelpPanel:
    """Toggleable key-binding overlay (reference behavior: hud.py:204-224).

    Original implementation: the panel is laid out from a two-column binding
    table (key, action) sized by font metrics, drawn centered with a dark
    translucent backdrop only while toggled on; nothing is pre-rendered at
    construction time.
    """

    BINDINGS = [
        ("W / Up", "throttle"),
        ("A / Left", "steer left"),
        ("D / Right", "steer right"),
        ("S / Down", "brake (reverse throttle)"),
        ("SPACE", "start/stop recording (collector)"),
        ("H", "toggle this help"),
        ("ESC", "quit"),
    ]

    def __init__(self, font, screen_size):
        self.font = font
        self.screen_w, self.screen_h = screen_size
        self.visible = False

    def toggle(self):
        self.visible = not self.visible

    def render(self, display):
        if not self.visible:
            return
        import pygame

        line_h = self.font.get_linesize() + 4
        key_w = max(self.font.size(k)[0] for k, _ in self.BINDINGS)
        act_w = max(self.font.size(a)[0] for _, a in self.BINDINGS)
        pad, gap = 14, 24
        w = key_w + gap + act_w + 2 * pad
        h = line_h * len(self.BINDINGS) + 2 * pad
        x = (self.screen_w - w) // 2
        y = (self.screen_h - h) // 2

        backdrop = pygame.Surface((w, h))
        backdrop.fill((12, 12, 12))
        backdrop.set_alpha(200)
        display.blit(backdrop, (x, y))
        row_y = y + pad
        for key, action in self.BINDINGS:
            display.blit(
                self.font.render(key, True, (255, 220, 120)), (x + pad, row_y)
            )
            display.blit(
                self.font.render(action, True, (235, 235, 235)),
                (x + pad + key_w + gap, row_y),
            )
            row_y += line_h


class HUD:
    """Telemetry overlay (reference behavior: hud.py:36-169)."""

    PANEL_ALPHA = 140
    PANEL_PAD = 6
    GAUGE_W = 96
    GAUGE_H = 8

    def __init__(self, width: int, height: int):
        import pygame

        self.dim = (width, height)
        mono = pygame.font.match_font("mono") or pygame.font.get_default_font()
        self._font_mono = pygame.font.Font(mono, 13)
        self._font_notify = pygame.font.Font(
            pygame.font.get_default_font(), 18
        )
        self._notifications = NotificationStack(
            self._font_notify, (width, height)
        )
        self.help = HelpPanel(self._font_notify, (width, height))
        self.frame_count = 0
        self.sim_time = 0.0
        self.client_fps = 0.0
        self.server_fps = 0.0  # "server" = the compiled step program

    def tick(self, env, clock) -> None:
        self.frame_count += 1
        self.sim_time = _floats(env.state.time)[0] if env.state is not None else 0.0
        self.client_fps = clock.get_fps()
        self.server_fps = env.fps  # synchronous: locked to env fps

    def notification(self, text: str, seconds: float = 2.0) -> None:
        self._notifications.push(text, seconds=seconds)

    def error(self, text: str) -> None:
        self._notifications.push(f"Error: {text}", color=(255, 60, 60))

    def render(self, display, env, extra_info: List[str]) -> None:
        import pygame

        state = env.state
        speed_kmh = 3.6 * _floats(state.vehicle.speed)[0]
        x, y = _floats(state.vehicle.pos)[:2]
        steer, throttle = _floats(state.control)[:2]
        info_text = [
            f"Server:  {self.server_fps:16.0f} FPS",
            f"Client:  {self.client_fps:16.0f} FPS",
            "",
            f"Sim time: {datetime.timedelta(seconds=int(self.sim_time))}",
            "",
            f"Speed:   {speed_kmh:20.2f} km/h",
            f"Heading: {_floats(state.vehicle.yaw)[0]:20.2f} rad",
            f"Location: ({x:5.1f}, {y:5.1f})",
            "",
            # Sentinels expanded into bar gauges below (reference behavior:
            # hud.py:134-147 draws bars for the control channels). Steer is
            # bipolar (marker swings from the bar center), throttle fills
            # from the left.
            ("gauge", "Steer", steer, True),
            ("gauge", "Throttle", throttle, False),
            "",
        ] + list(extra_info)

        # Panel sized to its content: width from the widest line, height from
        # the font's line spacing (no fixed pixel table).
        line_h = self._font_mono.get_linesize()
        labels = [
            None
            if not item or isinstance(item, tuple)
            else self._font_mono.render(item, True, (255, 255, 255))
            for item in info_text
        ]
        gauge_row_w = (
            self._font_mono.size("Throttle -0.00  ")[0] + self.GAUGE_W
        )
        panel_w = (
            max(
                max((l.get_width() for l in labels if l is not None), default=120),
                gauge_row_w,
            )
            + 2 * self.PANEL_PAD
        )
        panel = pygame.Surface((panel_w, self.dim[1]))
        panel.set_alpha(self.PANEL_ALPHA)
        display.blit(panel, (0, 0))

        y = self.PANEL_PAD
        for item, label in zip(info_text, labels):
            if y + line_h > self.dim[1]:
                break
            if isinstance(item, tuple) and item[0] == "gauge":
                self._draw_gauge(display, item[1], item[2], item[3], y, line_h)
            elif label is not None:
                display.blit(label, (self.PANEL_PAD, y))
            y += line_h
        self._notifications.render(display)
        self.help.render(display)

    def _draw_gauge(
        self, display, name: str, value: float, bipolar: bool, y: int, line_h: int
    ) -> None:
        """One labelled control gauge row.

        Bipolar gauges anchor at the bar midpoint and swing left/right with
        the sign of `value` (steer); unipolar gauges fill from the left
        (throttle). The current value also prints after the label.
        """
        import pygame

        label = self._font_mono.render(
            f"{name} {value:+.2f}" if bipolar else f"{name} {value:.2f}",
            True,
            (255, 255, 255),
        )
        display.blit(label, (self.PANEL_PAD, y))

        bar_x = self.PANEL_PAD + self._font_mono.size("Throttle -0.00  ")[0]
        bar_y = y + (line_h - self.GAUGE_H) // 2
        outline = pygame.Rect(bar_x, bar_y, self.GAUGE_W, self.GAUGE_H)
        pygame.draw.rect(display, (200, 200, 200), outline, 1)
        v = max(-1.0, min(1.0, value))
        if bipolar:
            mid = bar_x + self.GAUGE_W // 2
            fill_w = int(abs(v) * (self.GAUGE_W // 2 - 1))
            x0 = mid if v >= 0 else mid - fill_w
            fill = pygame.Rect(x0, bar_y + 1, max(fill_w, 1), self.GAUGE_H - 2)
        else:
            fill = pygame.Rect(
                bar_x + 1,
                bar_y + 1,
                max(int(v * (self.GAUGE_W - 2)), 1),
                self.GAUGE_H - 2,
            )
        pygame.draw.rect(display, (255, 255, 255), fill)
