"""Video recording of evaluation episodes (port of carla_ppo_tpu/utils/video.py).

An OpenCV MPEG .avi writer fed RGB uint8 frames, with a PNG-sequence
fallback (`<filename>.frames/`) when OpenCV cannot be imported. One
difference: a writer that OpenCV cannot open (a build without an MPEG
encoder) raises here, where the JAX package would write an empty file.
"""

from __future__ import annotations

import os

import numpy as np


class VideoRecorder:
    """add_frame takes RGB [H, W, 3], uint8 or floats in [0, 1]."""

    def __init__(self, filename: str, frame_size, fps: int = 30):
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        self.filename = filename
        self._writer = None
        self._png_dir = None
        self._frame_idx = 0
        try:
            import cv2
        except ImportError:
            self._png_dir = filename + ".frames"
            os.makedirs(self._png_dir, exist_ok=True)
            return
        self._cv2 = cv2
        self._writer = cv2.VideoWriter(
            filename, cv2.VideoWriter_fourcc(*"MPEG"), int(max(fps, 1)),
            (frame_size[1], frame_size[0]),  # (width, height)
        )
        if not self._writer.isOpened():
            self._writer = None
            raise RuntimeError(f"OpenCV cannot open an MPEG writer for {filename}")

    def add_frame(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
        if self._writer is not None:
            self._writer.write(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))
        else:
            from PIL import Image

            Image.fromarray(frame).save(os.path.join(self._png_dir, f"{self._frame_idx:06d}.png"))
        self._frame_idx += 1

    def release(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass
