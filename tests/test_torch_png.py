"""The port's PNG codec (carla_ppo_tpu_torch/utils/png.py) against Pillow,
and its dataset loader against the JAX package's (which reads with
Pillow): bit for bit both ways.

- Files Pillow writes (its default adaptive filtering mixes None, Sub, Up
  and Paeth rows; `optimize` and low compression levels too) read back
  equal; files the codec writes, Pillow reads back equal; gray, RGB and
  RGBA, at the camera's 80x160 and at odd sizes.
- Every one of the five filter types, each on every row, from a reference
  filter written here after the PNG specification.
- utils.datasets.load_images equals the JAX datasets.load_images on a
  folder of both writers' files, names sorted numerically.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from carla_ppo_tpu.utils import datasets as jdatasets
from carla_ppo_tpu_torch.utils import datasets as tdatasets
from carla_ppo_tpu_torch.utils.png import decode_png, encode_png, read_png, write_png

SHAPES = [(80, 160), (80, 160, 3), (80, 160, 4), (7, 13, 3), (1, 1)]


def _images(shape, seed=0):
    """A noise image and a smooth one (where the filters pay off)."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, size=shape, dtype=np.uint8)
    h, w = shape[:2]
    ramp = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)
    planes = [ramp] if len(shape) == 2 else [ramp + 40 * c for c in range(shape[2])]
    smooth = (np.stack(planes, -1) % 256).astype(np.uint8).reshape(shape)
    return noise, smooth


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reads_what_pillow_writes_and_pillow_reads_it(shape):
    for img in _images(shape):
        for options in ({}, {"optimize": True}, {"compress_level": 1}):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG", **options)
            got = decode_png(buf.getvalue())
            assert got.dtype == np.uint8 and got.shape == img.shape
            np.testing.assert_array_equal(got, img)
        back = np.asarray(Image.open(io.BytesIO(encode_png(img))))
        assert back.shape == img.shape
        np.testing.assert_array_equal(back, img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """A PNG of `img` whose every row uses filter `ftype`."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        raw.append(ftype)
        for i in range(rows.shape[1]):
            x = int(rows[y, i])
            a = int(rows[y, i - bpp]) if i >= bpp else 0
            b = int(rows[y - 1, i]) if y > 0 else 0
            c = int(rows[y - 1, i - bpp]) if y > 0 and i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            raw.append((x - pred) % 256)
    color = {1: 0, 3: 2, 4: 6}[bpp]

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_every_filter_type(ftype):
    for shape in ((9, 11), (9, 11, 3), (6, 5, 4)):
        for img in _images(shape, seed=ftype):
            data = _filtered_png(img, ftype)
            np.testing.assert_array_equal(decode_png(data), img)
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)


def test_refuses_what_it_does_not_read():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    bad = bytearray(encode_png(np.zeros((2, 2), np.uint8)))
    bad[-20] ^= 0xFF  # inside the IDAT body: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2), np.float32))


def test_load_images_matches_jax(tmp_path):
    """A folder of 12 RGB frames, half written by the codec and half by
    Pillow, named 0..11 (numeric order differs from the string order)."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(12, 80, 160, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        path = os.path.join(tmp_path, f"{i}.png")
        if i % 2:
            Image.fromarray(f).save(path)
        else:
            write_png(path, f)
        np.testing.assert_array_equal(read_png(path), f)
    for fn in ("preprocess_rgb_frame", "preprocess_seg_frame"):
        want = jdatasets.load_images(str(tmp_path), getattr(jdatasets, fn), limit=10)
        got = tdatasets.load_images(str(tmp_path), getattr(tdatasets, fn), limit=10)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
