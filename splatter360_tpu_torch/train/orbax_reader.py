"""A reader of the JAX package's orbax checkpoints, in Python and numpy.

splatter360_tpu/train/checkpoint.py saves {"params", "opt_state", "step"}
with orbax's CheckpointManager and StandardSave:

    <directory>/<step>/_CHECKPOINT_METADATA
    <directory>/<step>/default/_METADATA        tree_metadata: key paths, types
    <directory>/<step>/default/manifest.ocdbt   the OCDBT database's root
    <directory>/<step>/default/d/<hex>          B+tree nodes
    <directory>/<step>/default/ocdbt.process_<i>/...   per-process nodes and
                                                       out-of-line values

The database maps "<dotted key path>/.zarray" to a zarr v2 array header
(JSON) and "<dotted key path>/<i.j...>" to its zstd-compressed chunks. The
formats are public: the "OCDBT format" page of TensorStore's documentation
(google.github.io/tensorstore/kvstore/ocdbt) and the zarr v2 specification.
This reader needs neither tensorstore nor orbax, only the zstd runtime
library (utils/zstd.py). It checks every magic number, version, length and
checksum it parses, and raises, naming the file and the key, on anything it
does not know (zarr v3, another compressor or dtype, a newer OCDBT version, a
numbered manifest, a missing chunk or value); it never drops a key.

    steps(directory)            finished orbax steps, ascending (orbax's rules)
    read_database(directory)    {key: value} of an OCDBT database
    read_checkpoint(step_dir)   {"params", "opt_state", "step"}: nested dicts
                                of numpy arrays (sequence indices as "0",
                                "1", ...; an empty optax state is None;
                                bfloat16 as float32 of the same values)
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path

import numpy as np

from ..utils import zstd

ITEM = "default"
STEP_METADATA = "_CHECKPOINT_METADATA"
_STEP_NAME = re.compile(r"(0|[1-9]\d*)")

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# an OCDBT file: magic (uint32 big-endian), length (uint64 little-endian),
# version and compression (varints), the body, crc32c (uint32 little-endian)
_HEADER_BYTES = 12


class OrbaxFormatError(ValueError):
    """A checkpoint file this reader cannot read; names the file and key."""


def is_step_dir(path: Path) -> bool:
    """A finished orbax step: a directory named as orbax names steps (not a
    `<step>.orbax-checkpoint-tmp-*` directory) that orbax has written into."""
    return (path.is_dir() and _STEP_NAME.fullmatch(path.name) is not None
            and ((path / STEP_METADATA).is_file() or (path / ITEM).is_dir()))


def steps(directory) -> list[int]:
    """The finished orbax steps under `directory`, ascending (the steps
    CheckpointManager.latest_step takes the highest of)."""
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir() if is_step_dir(p))


# --- crc32c (Castagnoli), the OCDBT files' footer -----------------------------

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --- byte reader ---------------------------------------------------------------

class _Cursor:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise OrbaxFormatError(f"{self.where}: {what} (at byte {self.pos} of {len(self.data)})")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail(f"truncated: {n} more bytes expected")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self, limit: int = 1 << 64) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift >= 64:
                self.fail("varint longer than 64 bits")
        if value >= limit:
            self.fail(f"value {value} out of range (< {limit})")
        return value

    def varints(self, n: int, limit: int = 1 << 64) -> list[int]:
        return [self.varint(limit) for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} trailing bytes")


def _envelope(buf: bytes, magic: int, where: str, max_body: int | None = None) -> _Cursor:
    """Check an OCDBT file's header (magic, length, version 0, compression)
    and crc32c footer; a cursor over its decoded body."""
    if len(buf) < _HEADER_BYTES + 2 + 4:
        raise OrbaxFormatError(f"{where}: {len(buf)} bytes is too short for an OCDBT file")
    got_magic = struct.unpack(">I", buf[:4])[0]
    (length,) = struct.unpack("<Q", buf[4:12])
    if got_magic != magic:
        raise OrbaxFormatError(f"{where}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(buf):
        raise OrbaxFormatError(f"{where}: header length {length} != {len(buf)} bytes read")
    (footer,) = struct.unpack("<I", buf[-4:])
    if crc32c(buf[:-4]) != footer:
        raise OrbaxFormatError(f"{where}: crc32c mismatch")
    c = _Cursor(buf[:-4], where)
    c.pos = _HEADER_BYTES
    version = c.varint()
    if version != 0:
        raise OrbaxFormatError(f"{where}: OCDBT format version {version} (this reader knows 0)")
    compression = c.varint()
    body = buf[c.pos:-4]
    if compression == 1:
        try:
            body = zstd.decompress(body)
        except RuntimeError as e:
            raise OrbaxFormatError(f"{where}: {e}") from e
    elif compression != 0:
        raise OrbaxFormatError(f"{where}: unknown compression format {compression}")
    if max_body is not None and len(body) > max_body:
        raise OrbaxFormatError(f"{where}: node of {len(body)} bytes exceeds the "
                               f"configured {max_body}")
    return _Cursor(body, where)


def _data_file_table(c: _Cursor) -> list[str]:
    """The files a node or manifest refers to, as paths relative to the
    database directory (base path + relative path; prefix-compressed)."""
    n = c.varint(1 << 32)
    prefix = [0] + c.varints(max(n - 1, 0), 1 << 32)
    suffix = c.varints(n, 1 << 32)
    base = c.varints(n, 1 << 32)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            c.fail(f"data file {i}: prefix {prefix[i]} longer than the previous path")
        path = prev[:prefix[i]] + c.take(suffix[i])
        if base[i] > len(path):
            c.fail(f"data file {i}: base path length {base[i]} > path length {len(path)}")
        if b".." in path.split(b"/") or path.startswith(b"/"):
            c.fail(f"data file {i}: path {path!r} leaves the database directory")
        paths.append(path.decode())
        prev = path
    return paths


class _Database:
    """One OCDBT database directory (a step's `default/`), read-only."""

    def __init__(self, root: Path):
        self.root = root
        self.files: dict[str, bytes] = {}
        where = str(root / "manifest.ocdbt")
        try:
            buf = (root / "manifest.ocdbt").read_bytes()
        except OSError as e:
            raise OrbaxFormatError(f"{where}: cannot read the OCDBT manifest: {e}") from e
        c = _envelope(buf, MANIFEST_MAGIC, where)
        c.take(16)  # the database's uuid
        kind = c.varint()
        if kind != 0:
            c.fail(f"manifest kind {kind}: only a single-file manifest (0) is read")
        c.varint()  # max_inline_value_bytes
        self.max_node = c.varint()
        arity_log2 = c.u8()
        if not 1 <= arity_log2 <= 16:
            c.fail(f"version tree arity log2 {arity_log2}")
        method = c.varint()
        if method == 1:
            c.take(4)  # zstd level, int32le
        elif method != 0:
            c.fail(f"unknown compression method {method}")
        files = _data_file_table(c)
        n = c.varint(1 << 32)
        if n == 0:
            c.fail("no version in the manifest")
        generation = c.varints(n)
        height = [c.u8() for _ in range(n)]
        refs = list(zip(c.varints(n, len(files)), c.varints(n), c.varints(n)))
        c.varints(n)  # num_keys
        c.varints(n)  # num_tree_bytes
        c.varints(n)  # num_indirect_value_bytes
        c.take(8 * n)  # commit times
        # references to the version tree's older nodes, which this reader
        # does not need: the newest version is always inline
        m = c.varint(1 << 32)
        c.varints(m)  # generation numbers
        c.varints(m, len(files)), c.varints(m), c.varints(m)  # file, offset, length
        c.varints(m)  # num_generations
        c.take(8 * m)  # commit times
        c.take(m)  # heights
        c.end()
        if generation != sorted(generation):
            c.fail("versions out of order")
        last = n - 1
        self.root_height = height[last]
        file_id, offset, length = refs[last]
        self.root_ref = (files[file_id], offset, length)

    def read(self, path: str, offset: int, length: int, what: str) -> bytes:
        if path not in self.files:
            try:
                self.files[path] = (self.root / path).read_bytes()
            except OSError as e:
                raise OrbaxFormatError(f"{self.root / path}: cannot read ({what}): {e}") from e
        data = self.files[path]
        if offset + length > len(data):
            raise OrbaxFormatError(f"{self.root / path}: {what} at bytes [{offset}, "
                                   f"{offset + length}) but the file has {len(data)} "
                                   f"(truncated?)")
        return data[offset:offset + length]

    def items(self) -> dict[str, bytes]:
        """Every key of the newest version and its value."""
        out: dict[str, bytes] = {}
        self._walk(self.root_ref, self.root_height, b"", out)
        return out

    def _walk(self, ref, height: int, prefix: bytes, out: dict):
        path, offset, length = ref
        where = f"{self.root / path} [{offset}:{offset + length}]"
        c = _envelope(self.read(path, offset, length, "a B+tree node"), NODE_MAGIC, where,
                      self.max_node)
        got = c.u8()
        if got != height:
            c.fail(f"node height {got}, its parent says {height}")
        files = _data_file_table(c)
        n = c.varint(1 << 32)
        if n == 0:
            c.fail("empty node")
        key_prefix = [0] + c.varints(n - 1, 1 << 32)
        key_suffix = c.varints(n, 1 << 32)
        if height > 0:
            common = c.varints(n, 1 << 32)
        keys, prev = [], b""
        for i in range(n):
            if key_prefix[i] > len(prev):
                c.fail(f"entry {i}: key prefix {key_prefix[i]} > previous key length")
            prev = prev[:key_prefix[i]] + c.take(key_suffix[i])
            keys.append(prev)
        if height > 0:
            child = list(zip(c.varints(n, len(files)), c.varints(n), c.varints(n)))
            c.varints(n)  # num_keys
            c.varints(n)  # num_tree_bytes
            c.varints(n)  # num_indirect_value_bytes
            c.end()
            for i in range(n):
                if common[i] > len(keys[i]):
                    c.fail(f"entry {i}: subtree prefix {common[i]} > key length")
                file_id, off, ln = child[i]
                self._walk((files[file_id], off, ln), height - 1,
                           prefix + keys[i][:common[i]], out)
            return
        value_length = c.varints(n)
        kind = c.varints(n)
        if any(k not in (0, 1) for k in kind):
            c.fail(f"unknown value kinds {sorted(set(kind) - {0, 1})}")
        n_indirect = sum(kind)
        ind_file = c.varints(n_indirect, len(files))
        ind_offset = c.varints(n_indirect)
        inline = c.take(sum(ln for ln, k in zip(value_length, kind) if k == 0))
        c.end()
        pos, j = 0, 0
        for key, ln, k in zip(keys, value_length, kind):
            full = (prefix + key).decode()
            if k == 0:
                out[full] = inline[pos:pos + ln]
                pos += ln
            else:
                out[full] = self.read(files[ind_file[j]], ind_offset[j], ln,
                                      f"the value of key {full!r}")
                j += 1


def read_database(directory) -> dict[str, bytes]:
    """Every key of the newest version of the OCDBT database in `directory`
    (a step's `default/`) and its value."""
    return _Database(Path(directory)).items()


# --- zarr v2 arrays ------------------------------------------------------------

_DTYPES = {"<f4": np.float32, "<i4": np.int32, "<i8": np.int64}


def _zarr_array(db: _Database, items: dict, name: str) -> np.ndarray:
    """The zarr v2 array stored under `name` (C order, zstd or raw chunks);
    `items` maps the keys under `name/` (".zarray", "0.0", ...) to values.
    numpy has no bfloat16: its chunks are read as uint16 bits and the array
    comes back as the float32 of the same values (the bits shifted left by
    16, exact)."""
    where = f"{db.root} key {name!r}"
    raw = items.get(".zarray")
    if raw is None:
        if "zarr.json" in items:
            raise OrbaxFormatError(f"{where}: a zarr v3 array; only zarr v2 is read")
        raise OrbaxFormatError(f"{where}: no value (missing {name}/.zarray)")
    try:
        meta = json.loads(raw)
    except ValueError as e:
        raise OrbaxFormatError(f"{where}: .zarray is not JSON: {e}") from e
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{where}: zarr_format {meta.get('zarr_format')!r}, expected 2")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{where}: order {meta.get('order')!r}; only C is read")
    if meta.get("filters") not in (None, []):
        raise OrbaxFormatError(f"{where}: filters {meta['filters']!r} are not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {compressor!r}; only zstd or none is read")
    dtype_name = meta.get("dtype")
    if dtype_name == "bfloat16":
        dtype = np.dtype(np.uint16)
    elif dtype_name in _DTYPES:
        dtype = np.dtype(_DTYPES[dtype_name])
    else:
        raise OrbaxFormatError(f"{where}: dtype {dtype_name!r} is not read")
    shape = tuple(int(s) for s in meta["shape"])
    chunks = tuple(int(s) for s in meta["chunks"])
    if len(chunks) != len(shape) or any(ch <= 0 for ch in chunks):
        raise OrbaxFormatError(f"{where}: chunks {chunks} do not fit shape {shape}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OrbaxFormatError(f"{where}: dimension_separator {sep!r}")
    out = np.empty(shape, dtype)
    grid = [-(-s // ch) for s, ch in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = sep.join(str(i) for i in index) or "0"
        data = items.get(key)
        if data is None:
            raise OrbaxFormatError(f"{where}: chunk {key!r} is missing (fill_value "
                                   f"{meta.get('fill_value')!r} is not applied)")
        if compressor is not None:
            try:
                data = zstd.decompress(data, chunk_bytes)
            except RuntimeError as e:
                raise OrbaxFormatError(f"{where}: chunk {key!r}: {e}") from e
        if len(data) != chunk_bytes:
            raise OrbaxFormatError(f"{where}: chunk {key!r} holds {len(data)} bytes, "
                                   f"expected {chunk_bytes}")
        block = np.frombuffer(data, dtype).reshape(chunks)
        sl = tuple(slice(i * ch, min((i + 1) * ch, s)) for i, ch, s in zip(index, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if dtype_name == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


# --- the checkpoint ------------------------------------------------------------

def _tree_metadata(path: Path) -> dict:
    try:
        meta = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        raise OrbaxFormatError(f"{path}: cannot read orbax's tree metadata: {e}") from e
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: use_zarr3 is set; only zarr v2 is read")
    if meta.get("use_ocdbt") is False:
        raise OrbaxFormatError(f"{path}: use_ocdbt is off; only OCDBT checkpoints are read")
    if "tree_metadata" not in meta:
        raise OrbaxFormatError(f"{path}: no tree_metadata")
    return meta["tree_metadata"]


def read_checkpoint(step_dir) -> dict:
    """{"params", "opt_state", "step"} of an orbax StandardSave step
    directory, as nested dicts of numpy arrays keyed by the tree's dict keys
    and sequence indices (as strings); leaves orbax stored as None (an
    empty optax state) are None; bfloat16 leaves come back as float32 of the
    same values. Any other layout raises OrbaxFormatError."""
    step_dir = Path(step_dir)
    item = step_dir / ITEM
    if not item.is_dir():
        raise OrbaxFormatError(f"{step_dir}: not an orbax step directory (no {ITEM}/)")
    tree_meta = _tree_metadata(item / "_METADATA")
    db = _Database(item)
    by_name: dict[str, dict[str, bytes]] = {}
    for key, value in db.items().items():
        name, _, sub = key.partition("/")
        by_name.setdefault(name, {})[sub] = value
    tree: dict = {}
    for entry in tree_meta.values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value.get("value_type")
        name = ".".join(keys)
        if kind == "None" or value.get("skip_deserialize"):
            leaf = None
        elif kind in ("jax.Array", "np.ndarray", "scalar"):
            leaf = _zarr_array(db, by_name.pop(name, {}), name)
            want = value.get("write_shape")
            if want is not None and list(leaf.shape) != list(want):
                raise OrbaxFormatError(f"{item} key {name!r}: shape {leaf.shape}, metadata "
                                       f"says {want}")
        else:
            raise OrbaxFormatError(f"{item} key {name!r}: value type {kind!r} is not read")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise OrbaxFormatError(f"{item} key {name!r}: a leaf and a subtree share "
                                       f"a path")
        node[keys[-1]] = leaf
    if by_name:
        stray = sorted(by_name)
        raise OrbaxFormatError(f"{item}: keys under {stray[:5]} ({len(stray)} in all) belong "
                               f"to no leaf of the tree metadata")
    missing = [k for k in ("params", "opt_state", "step") if k not in tree]
    if missing:
        raise OrbaxFormatError(f"{item}: no {missing} in the tree (not a train state "
                               f"saved by save_checkpoint)")
    return tree
