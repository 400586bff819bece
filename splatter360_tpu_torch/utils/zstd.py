"""A ctypes binding of the zstd runtime library (libzstd.so.1).

Reads the zstd frames of the JAX package's files where no zstd headers and
no Python zstd module are installed: the zarr chunks and OCDBT nodes of its
orbax checkpoints (train/orbax_reader.py). The native scene-shard loader
links the same library (native/__init__.py takes `library_path()`).

    data = decompress(frame)              # frames with or without a content size
    data = decompress(frame, size=n)      # one call when the size is known

There is no fallback: where the library cannot be loaded every call raises
a RuntimeError that names libzstd.so.1.
"""

from __future__ import annotations

import ctypes
import ctypes.util

SONAME = "libzstd.so.1"
_LIB = None
_PATH: str | None = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _find() -> list[str]:
    found = ctypes.util.find_library("zstd")
    return [found, SONAME] if found and found != SONAME else [SONAME]


def _load():
    global _LIB, _PATH
    if _LIB is not None:
        return _LIB
    errors = []
    for name in _find():
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            errors.append(f"{name}: {e}")
            continue
        break
    else:
        raise RuntimeError(f"the zstd runtime library {SONAME} cannot be loaded "
                           f"({'; '.join(errors)}); install libzstd1")
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for fn, res, args in (
            ("ZSTD_isError", ctypes.c_uint, [size_t]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
            ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
            ("ZSTD_createDStream", vp, []),
            ("ZSTD_freeDStream", size_t, [vp]),
            ("ZSTD_initDStream", size_t, [vp]),
            ("ZSTD_DStreamOutSize", size_t, []),
            ("ZSTD_decompressStream", size_t,
             [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)])):
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    _LIB = lib
    _PATH = _resolved(lib, name)
    return lib


class _DlInfo(ctypes.Structure):
    _fields_ = [("fname", ctypes.c_char_p), ("fbase", ctypes.c_void_p),
                ("sname", ctypes.c_char_p), ("saddr", ctypes.c_void_p)]


def _resolved(lib, name: str) -> str:
    """The file the dynamic loader mapped for `lib` (dladdr of one of its
    functions; `name` where that fails)."""
    info = _DlInfo()
    try:
        dladdr = ctypes.CDLL(None).dladdr
    except (OSError, AttributeError):
        return name
    dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    if dladdr(ctypes.cast(lib.ZSTD_decompress, ctypes.c_void_p), ctypes.byref(info)) and \
            info.fname:
        return info.fname.decode()
    return name


def library_path() -> str:
    """The path of the loaded libzstd (loads it; RuntimeError if missing)."""
    _load()
    return _PATH


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise RuntimeError(f"zstd {what} failed: {lib.ZSTD_getErrorName(code).decode()}")
    return code


_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2


def decompress(data: bytes, size: int | None = None) -> bytes:
    """The decompressed bytes of the zstd frame(s) in `data`. With `size`
    (or a content size in the frame header) one call that must produce
    exactly that many bytes; otherwise the streaming decoder."""
    lib = _load()
    data = bytes(data)
    if size is None:
        known = lib.ZSTD_getFrameContentSize(data, len(data))
        if known == _CONTENTSIZE_ERROR:
            raise RuntimeError("zstd decompress failed: not a zstd frame")
        if known != _CONTENTSIZE_UNKNOWN:
            size = int(known)
    if size is not None:
        out = ctypes.create_string_buffer(max(size, 1))
        got = _check(lib, lib.ZSTD_decompress(out, size, data, len(data)), "decompress")
        if got != size:
            raise RuntimeError(f"zstd decompress gave {got} bytes, expected {size}")
        return out.raw[:size]
    return _stream(lib, data)


def _stream(lib, data: bytes) -> bytes:
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise RuntimeError("ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(ds), "initDStream")
        src = ctypes.create_string_buffer(data, len(data))
        cap = lib.ZSTD_DStreamOutSize()
        dst = ctypes.create_string_buffer(cap)
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        parts = []
        while True:
            outb = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), cap, 0)
            left = _check(lib, lib.ZSTD_decompressStream(ds, ctypes.byref(outb),
                                                         ctypes.byref(inb)), "decompressStream")
            parts.append(ctypes.string_at(dst, outb.pos))
            if inb.pos < inb.size or outb.pos == cap:
                continue  # more input to read, or more output to flush
            if left == 0:
                return b"".join(parts)
            raise RuntimeError("zstd decompress failed: the frame is truncated")
    finally:
        lib.ZSTD_freeDStream(ds)
