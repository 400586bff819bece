"""Image IO and layout helpers without imageio or matplotlib.

Counterpart of splatter360_tpu/utils/image_io.py (`to_uint8`, `save_image`,
`load_image`, `save_video`, `hcat`, `vcat`, `add_label`,
`apply_depth_colormap`). PNG files are written and read with zlib and
struct: 8-bit grey, grey+alpha, RGB, RGBA or palette images, not interlaced
(the PNG files imageio and Pillow write by default). The depth colormap
indexes matplotlib's 256-entry `inferno` table (utils/inferno.py) as
matplotlib does. `add_label` draws its text with a 5x7 bitmap font of its
own (upper case, digits and some punctuation; PIL is not needed), so its
glyphs differ from PIL's while its banner and the image keep JAX's shapes
and pixels.
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
# 5x7 glyphs, one 5-bit row each (bit 4 the left column); lower case is drawn
# in upper case, any other character as "?"
_FONT = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "0": (14, 17, 19, 21, 25, 17, 14), "1": (4, 12, 4, 4, 4, 4, 14),
    "2": (14, 17, 1, 2, 4, 8, 31), "3": (31, 2, 4, 2, 1, 17, 14),
    "4": (2, 6, 10, 18, 31, 2, 2), "5": (31, 16, 30, 1, 1, 17, 14),
    "6": (6, 8, 16, 30, 17, 17, 14), "7": (31, 1, 2, 4, 8, 8, 8),
    "8": (14, 17, 17, 14, 17, 17, 14), "9": (14, 17, 17, 15, 1, 2, 12),
    "A": (14, 17, 17, 17, 31, 17, 17), "B": (30, 17, 17, 30, 17, 17, 30),
    "C": (14, 17, 16, 16, 16, 17, 14), "D": (28, 18, 17, 17, 17, 18, 28),
    "E": (31, 16, 16, 30, 16, 16, 31), "F": (31, 16, 16, 30, 16, 16, 16),
    "G": (14, 17, 16, 23, 17, 17, 15), "H": (17, 17, 17, 31, 17, 17, 17),
    "I": (14, 4, 4, 4, 4, 4, 14), "J": (7, 2, 2, 2, 2, 18, 12),
    "K": (17, 18, 20, 24, 20, 18, 17), "L": (16, 16, 16, 16, 16, 16, 31),
    "M": (17, 27, 21, 21, 17, 17, 17), "N": (17, 17, 25, 21, 19, 17, 17),
    "O": (14, 17, 17, 17, 17, 17, 14), "P": (30, 17, 17, 30, 16, 16, 16),
    "Q": (14, 17, 17, 17, 21, 18, 13), "R": (30, 17, 17, 30, 20, 18, 17),
    "S": (15, 16, 16, 14, 1, 1, 30), "T": (31, 4, 4, 4, 4, 4, 4),
    "U": (17, 17, 17, 17, 17, 17, 14), "V": (17, 17, 17, 17, 17, 10, 4),
    "W": (17, 17, 17, 21, 21, 21, 10), "X": (17, 17, 10, 4, 10, 17, 17),
    "Y": (17, 17, 17, 10, 4, 4, 4), "Z": (31, 1, 2, 4, 8, 16, 31),
    ".": (0, 0, 0, 0, 0, 12, 12), ",": (0, 0, 0, 0, 12, 4, 8),
    ":": (0, 12, 12, 0, 12, 12, 0), "-": (0, 0, 0, 31, 0, 0, 0),
    "_": (0, 0, 0, 0, 0, 0, 31), "/": (0, 1, 2, 4, 8, 16, 0),
    "(": (2, 4, 8, 8, 8, 4, 2), ")": (8, 4, 2, 2, 2, 4, 8),
    "=": (0, 0, 31, 0, 31, 0, 0), "+": (0, 4, 4, 31, 4, 4, 0),
    "%": (24, 25, 2, 4, 8, 19, 3), "?": (14, 17, 1, 2, 4, 0, 4),
}


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


def save_video(frames, path, fps: int = 30) -> None:
    """frames: [H, W, 3] images in [0, 1] (or uint8). Written as an mp4v
    video with cv2 where it imports and its writer works, else as PNG frames
    in the directory `path` without its suffix."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    frames = [f if np.asarray(f).dtype == np.uint8 else to_uint8(f) for f in frames]
    try:
        import cv2

        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        if path.stat().st_size > 0:
            return
        raise RuntimeError("cv2 wrote an empty video")
    except Exception:
        frame_dir = path.with_suffix("")
        frame_dir.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            (frame_dir / f"{i:04d}.png").write_bytes(encode_png(f))


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


def add_label(img, text: str, height: int = 18):
    """A white banner `height` pixels tall above an [H, W, 3] image, with
    `text` in black from (4, 2) at twice the font's size, clipped at the
    right edge. Float images come back as float32 in [0, 1] (through
    uint8, as JAX's), uint8 as uint8."""
    arr = np.asarray(img)
    was_float = arr.dtype != np.uint8
    if was_float:
        arr = to_uint8(arr)
    banner = np.full((height, arr.shape[1], 3), 255, np.uint8)
    x = 4
    for ch in text.upper():
        rows = _FONT.get(ch, _FONT["?"])
        bits = np.array([[(r >> (4 - c)) & 1 for c in range(5)] for r in rows], bool)
        glyph = np.kron(bits, np.ones((2, 2), bool))[:height - 2, :max(arr.shape[1] - x, 0)]
        banner[2:2 + glyph.shape[0], x:x + glyph.shape[1]][glyph] = 0
        x += 12
    out = np.concatenate([banner, arr], axis=0)
    if was_float:
        out = out.astype(np.float32) / 255.0
    return out


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
