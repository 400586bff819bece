"""Image IO and layout helpers without imageio or matplotlib.

Counterpart of splatter360_tpu/utils/image_io.py (`to_uint8`, `save_image`,
`load_image`, `hcat`, `vcat`, `apply_depth_colormap`). PNG files are
written and read with zlib and struct: 8-bit grey, grey+alpha, RGB, RGBA
or palette images, not interlaced (the PNG files imageio and Pillow write
by default). The depth colormap indexes matplotlib's 256-entry `inferno`
table (utils/inferno.py) as matplotlib does. Videos (`save_video`) are not
ported.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .inferno import INFERNO

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_INFERNO = np.asarray(INFERNO, np.float64)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1-4) -> PNG bytes, no row filters."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _unfilter_sequential(kind: int, line: bytes, prev: bytearray, bpp: int) -> bytearray:
    """PNG filters 3 (average) and 4 (Paeth), which depend on the bytes just
    reconstructed to their left."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] (palette images expanded to RGB/RGBA)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, palette, alpha = 8, [], None, None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace} (8-bit, not interlaced only)")
    bpp = _CHANNELS[color]
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(kind, line.tobytes(), bytearray(prev), bpp),
                                np.uint8)
        else:
            raise ValueError(f"bad PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    img = out.reshape(h, w, bpp)
    if palette is not None and color == 3:
        table = palette
        if alpha is not None:
            a = np.full(len(palette), 255, np.uint8)
            a[:len(alpha)] = alpha
            table = np.concatenate([palette, a[:, None]], axis=1)
        img = table[img[..., 0]]
    return img


def save_image(img, path) -> None:
    """img [H, W, 3] float in [0, 1] (clipped, truncated to 8 bits) or uint8,
    written as PNG."""
    path = Path(path)
    if path.suffix.lower() != ".png":
        raise ValueError(f"save_image writes PNG files only, not {path.suffix!r}")
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    path.write_bytes(encode_png(arr))


def load_image(path) -> np.ndarray:
    """A PNG file -> float32 [H, W, C] in [0, 1]."""
    return decode_png(Path(path).read_bytes()).astype(np.float32) / 255.0


def hcat(*images, pad: int = 0):
    """Concatenate [H, W, C] images horizontally, padding heights with 1."""
    images = [np.asarray(i) for i in images]
    h = max(i.shape[0] for i in images)
    out = []
    for i in images:
        if i.shape[0] < h:
            i = np.pad(i, ((0, h - i.shape[0]), (0, 0), (0, 0)), constant_values=1.0)
        out.append(i)
        if pad:
            out.append(np.ones((h, pad, images[0].shape[-1]), i.dtype))
    if pad:
        out = out[:-1]
    return np.concatenate(out, axis=1)


def vcat(*images, pad: int = 0):
    """Concatenate [H, W, C] images vertically, padding widths with 1."""
    images = [np.asarray(i) for i in images]
    w = max(i.shape[1] for i in images)
    out = []
    for i in images:
        if i.shape[1] < w:
            i = np.pad(i, ((0, 0), (0, w - i.shape[1]), (0, 0)), constant_values=1.0)
        out.append(i)
        if pad:
            out.append(np.ones((pad, w, images[0].shape[-1]), i.dtype))
    if pad:
        out = out[:-1]
    return np.concatenate(out, axis=0)


def apply_depth_colormap(depth, near=None, far=None) -> np.ndarray:
    """Depth [H, W] -> inferno colours [H, W, 3] float32, between `near` and
    `far` (default: the 1st and 99th percentiles); NaN maps to black."""
    d = np.asarray(depth, np.float32)
    lo = np.percentile(d, 1) if near is None else near
    hi = np.percentile(d, 99) if far is None else far
    xa = np.array(np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1), copy=True)
    n = len(_INFERNO)
    xa *= n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[bad] = 0
    rgb = _INFERNO[idx]
    rgb[bad] = 0.0
    return rgb.astype(np.float32)
