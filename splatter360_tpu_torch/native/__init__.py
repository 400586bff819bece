"""ctypes binding of the scene-shard loader (loader.cpp), built at first use.

Counterpart of splatter360_tpu/native/__init__.py with the same .s3z format
(loader.cpp's header). The library is built with g++ into `native/build/`
(listed in .gitignore), named by a hash of the source and the command. It
needs no zstd headers: loader.cpp declares the four zstd functions it calls
and links the runtime library libzstd.so.1 by the path that utils/zstd.py
loads (or by soname). Where it cannot be built (no g++, no libzstd.so.1),
`available()` is False and `build_error()` says why; writers then store
npz files (data/scene_io.save_scene), and opening an existing shard raises
that reason: an .s3z scene is never skipped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..utils import zstd

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "loader.cpp"
BUILD_DIR = _HERE / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LIB = None
_ERROR: str | None = None


def _link() -> str:
    """The linker argument for libzstd: the file utils/zstd.py loaded, or
    the soname (RuntimeError naming libzstd.so.1 when it is missing)."""
    path = zstd.library_path()
    return path if os.path.isabs(path) else f"-l:{zstd.SONAME}"


def _lib_path(link: str) -> Path:
    digest = hashlib.sha1(" ".join((*FLAGS, link)).encode()
                          + SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libs3z_{digest}.so"


def _build(out: Path, link: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the scene-shard loader needs g++, which is not on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SOURCE), link, "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        log = proc.stderr.strip()
        what = f"linking {link} failed" if "zstd" in log.lower() else "g++ failed"
        raise RuntimeError(f"cannot build the scene-shard loader: {what}:\n{log[-2000:]}")
    os.replace(tmp, out)


def _load():
    global _LIB, _ERROR
    if _LIB is not None or _ERROR is not None:
        return _LIB
    try:
        link = _link()
        path = _lib_path(link)
        if not path.exists():
            _build(path, link)
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError) as e:
        _ERROR = str(e)
        return None
    lib.s3_open.restype = ctypes.c_void_p
    lib.s3_open.argtypes = [ctypes.c_char_p]
    lib.s3_close.argtypes = [ctypes.c_void_p]
    lib.s3_info.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint32)] * 3
    lib.s3_poses.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.s3_decode_frames.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
    lib.s3_decode_frames.restype = ctypes.c_int32
    lib.s3_zstd_compress.restype = ctypes.c_int64
    lib.s3_zstd_compress.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int]
    lib.s3_zstd_bound.restype = ctypes.c_int64
    lib.s3_zstd_bound.argtypes = [ctypes.c_int64]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the loader could not be built (None when it is available)."""
    _load()
    return _ERROR


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the scene-shard loader is unavailable: {_ERROR}")
    return lib


def _compress(lib, arr: np.ndarray, level: int = 3) -> bytes:
    raw = np.ascontiguousarray(arr).tobytes()
    cap = lib.s3_zstd_bound(len(raw))
    dst = ctypes.create_string_buffer(cap)
    got = lib.s3_zstd_compress(raw, len(raw), dst, cap, level)
    if got < 0:
        raise RuntimeError("zstd compression failed")
    return dst.raw[:got]


def write_shard(path, rgb_u8: np.ndarray, depth_mm_u16: np.ndarray, poses: np.ndarray,
                level: int = 3) -> None:
    """rgb [n, h, w, 3] u8; depth [n, h, w] u16 (mm); poses [n, 4, 4] f32."""
    lib = _require()
    n, h, w, _ = rgb_u8.shape
    rgb_blocks = [_compress(lib, rgb_u8[i], level) for i in range(n)]
    dep_blocks = [_compress(lib, depth_mm_u16[i], level) for i in range(n)]
    offsets = np.cumsum([0] + [len(b) for b in rgb_blocks + dep_blocks])
    header = b"S3Z1" + np.asarray([n, h, w], np.uint32).tobytes()
    header += np.asarray(poses, np.float32).tobytes()
    header += np.asarray(offsets[:n], np.uint64).tobytes()
    header += np.asarray([len(b) for b in rgb_blocks], np.uint64).tobytes()
    header += np.asarray(offsets[n:2 * n], np.uint64).tobytes()
    header += np.asarray([len(b) for b in dep_blocks], np.uint64).tobytes()
    with open(path, "wb") as f:
        f.write(header)
        for blk in rgb_blocks + dep_blocks:
            f.write(blk)


class Shard:
    """Reader over one .s3z scene shard with multithreaded decode."""

    def __init__(self, path, n_threads: int | None = None):
        self.lib = _require()
        self.handle = self.lib.s3_open(str(path).encode())
        if not self.handle:
            raise IOError(f"failed to open shard {path}")
        n, h, w = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
        self.lib.s3_info(self.handle, ctypes.byref(n), ctypes.byref(h), ctypes.byref(w))
        self.n_frames, self.h, self.w = n.value, h.value, w.value
        self.n_threads = n_threads or min(os.cpu_count() or 1, 8)

    def poses(self) -> np.ndarray:
        out = np.empty((self.n_frames, 4, 4), np.float32)
        self.lib.s3_poses(self.handle, out.ctypes.data_as(ctypes.c_void_p))
        return out

    def decode(self, indices, with_depth: bool = True):
        """(rgb [n, h, w, 3] u8, depth [n, h, w] u16 mm or None) of `indices`."""
        idx = np.ascontiguousarray(indices, np.int32)
        rgb = np.empty((len(idx), self.h, self.w, 3), np.uint8)
        depth = np.empty((len(idx), self.h, self.w), np.uint16) if with_depth else None
        rc = self.lib.s3_decode_frames(
            self.handle, idx.ctypes.data_as(ctypes.c_void_p), len(idx),
            rgb.ctypes.data_as(ctypes.c_void_p),
            depth.ctypes.data_as(ctypes.c_void_p) if with_depth else None, self.n_threads)
        if rc != 0:
            raise RuntimeError(f"shard decode failed (code {rc})")
        return rgb, depth

    def close(self):
        if getattr(self, "handle", None):
            self.lib.s3_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()
