"""Image-dataset loading for VAE training (port of
carla_ppo_tpu/utils/datasets.py): PNG frame folders, the RGB and
segmentation preprocessors, and the shuffled train / validation split.
PNGs are read by utils/png.py, so no imaging package is needed.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np

from carla_ppo_tpu_torch.utils.png import read_png


def preprocess_rgb_frame(frame: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 [0, 1]."""
    return (frame[..., :3].astype(np.float32)) / 255.0


def preprocess_seg_frame(frame: np.ndarray) -> np.ndarray:
    """CARLA's seg camera writes the class id in the red channel; the 13
    classes scale to [0, 1] by 1/12."""
    return frame[..., :1].astype(np.float32) / 12.0


def load_images(
    dir_path: str,
    preprocess_fn: Callable[[np.ndarray], np.ndarray],
    limit: int | None = None,
) -> np.ndarray:
    """Every PNG in a folder, numeric names in numeric order, then the
    rest by name; stacked after `preprocess_fn`."""
    names = [n for n in os.listdir(dir_path) if n.lower().endswith(".png")]

    def sort_key(n: str):
        stem = os.path.splitext(n)[0]
        return (0, int(stem)) if stem.isdigit() else (1, stem)

    names.sort(key=sort_key)
    if limit is not None:
        names = names[:limit]
    return np.stack([preprocess_fn(read_png(os.path.join(dir_path, n))) for n in names])


def train_val_split(
    images: np.ndarray, val_portion: float = 0.1, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled split, `val_portion` of the frames (at least one) for
    validation."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(images))
    n_val = max(int(len(images) * val_portion), 1)
    return images[idx[n_val:]], images[idx[:n_val]]
