"""A small PNG codec on zlib and numpy (no Pillow).

Reads and writes 8-bit non-interlaced PNGs: grayscale (colour type 0),
RGB (2) and RGBA (6). `read_png` undoes all five row filters (None, Sub,
Up, Average, Paeth), so it reads what other encoders write; `write_png`
writes every row unfiltered. Anything else (palettes, 16-bit samples,
interlacing) raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of a uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA) array."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"expected uint8 samples, got {image.dtype}")
    if image.ndim == 2:
        color_type = 0
    elif image.ndim == 3 and image.shape[2] in (3, 4):
        color_type = 2 if image.shape[2] == 3 else 6
    else:
        raise ValueError(f"expected [H, W], [H, W, 3] or [H, W, 4], got {image.shape}")
    h, w = image.shape[:2]
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 per row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstructed rows [h, stride] uint8 of the decompressed stream."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError(f"PNG image data has {buf.size} bytes, expected {h * (stride + 1)}")
    rows = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0).reshape(-1).astype(np.uint8)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one bpp to its left
            cur = bytearray(stride)
            up = prior.tolist()
            raw = line.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (raw[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} on row {y}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) of PNG
    bytes."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color_type}, "
                         f"interlace {interlace} (8-bit gray / RGB / RGBA, not interlaced)")
    ch = _CHANNELS[color_type]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return rows.reshape(h, w) if ch == 1 else rows.reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
