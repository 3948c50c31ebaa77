"""A stand-in for tkinter and PIL.ImageTk that records the inspectors' windows.

The inspection CLIs (cli/inspect_vae.run_ui, cli/inspect_agent.main) build
tkinter windows. `installed()` puts minimal `tkinter` and `PIL.ImageTk`
modules in their place for the duration: widgets record their options,
commands and values, `PhotoImage` records each image it is given as a
uint8 array, and `mainloop` returns at once. The callbacks stay callable
after the window "closed", so a caller drives the UI through the recorded
widgets:

    with torch_tk_stub.installed() as tk:
        inspect_vae.run_ui(model, source_dir)
        tk.scale("z3").command("1.5")
        tk.button("Set z by image").command()
    tk.images  # every image shown, in order

JAX-free, so that both the CPU parity tests and chip_smoke.py (on the
card's machine, which has no tkinter) use it.
"""

from __future__ import annotations

import contextlib
import sys
import types
from typing import Iterator, List

import numpy as np

HORIZONTAL = "horizontal"


class Recorder:
    """What the stand-in toolkit saw: windows, widgets in creation order,
    and the images shown (uint8 arrays)."""

    def __init__(self) -> None:
        self.widgets: List["Widget"] = []
        self.images: List[np.ndarray] = []
        self.windows: List["Tk"] = []

    def scale(self, label: str) -> "Widget":
        return self._find("Scale", "label", label)

    def button(self, text: str) -> "Widget":
        return self._find("Button", "text", text)

    def labels(self) -> List["Widget"]:
        return [w for w in self.widgets if w.kind == "Label"]

    def _find(self, kind: str, key: str, value: str) -> "Widget":
        found = [w for w in self.widgets if w.kind == kind and w.options.get(key) == value]
        if len(found) != 1:
            raise LookupError(f"{len(found)} {kind} widgets with {key}={value!r}")
        return found[0]


class Widget:
    def __init__(self, recorder: Recorder, kind: str, master=None, **options) -> None:
        self.kind, self.master, self.options = kind, master, dict(options)
        self.value = 0.0
        self.grid_options: dict = {}
        recorder.widgets.append(self)

    @property
    def command(self):
        return self.options.get("command")

    def grid(self, **options) -> None:
        self.grid_options = options

    def configure(self, **options) -> None:
        self.options.update(options)

    def set(self, value) -> None:
        """A Scale's set: the value only (tkinter calls the command when the
        value changes from the event loop, which never runs here)."""
        self.value = float(value)


def _tkinter(recorder: Recorder) -> types.ModuleType:
    mod = types.ModuleType("tkinter")
    mod.HORIZONTAL = HORIZONTAL

    class Tk:
        def __init__(self) -> None:
            self.looped = 0
            recorder.windows.append(self)

        def title(self, text: str) -> None:
            pass

        def mainloop(self) -> None:
            self.looped += 1

    mod.Tk = Tk
    for kind in ("Label", "Scale", "Button"):
        setattr(mod, kind, lambda master=None, _kind=kind, **kw: Widget(recorder, _kind, master, **kw))
    return mod


def _image_tk(recorder: Recorder) -> types.ModuleType:
    mod = types.ModuleType("PIL.ImageTk")

    class PhotoImage:
        def __init__(self, image) -> None:
            self.array = np.asarray(image, dtype=np.uint8).copy()
            recorder.images.append(self.array)

    mod.PhotoImage = PhotoImage
    return mod


@contextlib.contextmanager
def installed() -> Iterator[Recorder]:
    """The stand-in `tkinter` and `PIL.ImageTk` for the duration; the
    modules (and PIL's attribute) that were there before come back on
    exit."""
    import PIL

    recorder = Recorder()
    fakes = {"tkinter": _tkinter(recorder), "PIL.ImageTk": _image_tk(recorder)}
    saved = {name: sys.modules.get(name) for name in fakes}
    had_attr = hasattr(PIL, "ImageTk")
    saved_attr = getattr(PIL, "ImageTk", None)
    sys.modules.update(fakes)
    PIL.ImageTk = fakes["PIL.ImageTk"]
    try:
        yield recorder
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
        if had_attr:
            PIL.ImageTk = saved_attr
        else:
            del PIL.ImageTk
