"""Reader of the JAX package's checkpoints, without JAX, orbax or tensorstore.

``radardistill_tpu/train/checkpoint.py::CheckpointManager.save`` writes each
checkpoint as a directory ``checkpoint_epoch_{e}/`` through orbax's
``PyTreeCheckpointer``. The directory holds:

  - ``_METADATA``: JSON of the tree. Each leaf has its key path, each key a
    ``key_type`` (2 a dict key, 1 a sequence index), and a ``value_type``
    (``np.ndarray``, ``scalar``, ``string`` or ``None``; the frozen leaves
    that ``optax.masked`` leaves out and optax's empty states are ``None``);
  - ``_strings.json``: the string leaves (``version``);
  - an OCDBT key-value store (tensorstore's "optionally-cooperative
    distributed B-tree"): ``manifest.ocdbt`` and the data files it names
    (``d/...`` at the top, ``ocdbt.process_N/d/...`` for each writing
    process). Its keys are the leaves' zarr v2 arrays, named by the key path
    joined with dots: ``state.params.radar_vfe.pfn_0.linear.kernel/.zarray``
    (the JSON metadata) and ``.../0.0`` (a chunk, ``0`` for a 0-d array).

Every OCDBT manifest and B-tree node is one envelope: a big-endian u32 magic
(``0x0cdb3a2a`` a manifest, ``0x0cdb20de`` a node), the little-endian u64
length of the whole envelope, a version varint (0), a compression varint (0
none, 1 zstd), the body, and a little-endian CRC-32C of every byte before it.
A body is columnar: a table of the data files it refers to, then for each
field the values of all its entries (varints, key suffixes delta-coded against
the previous key). A leaf entry's value is inline in the node, or a
(data file, offset, length) reference into a data file; an interior entry
refers to a child node, whose keys drop the entry's subtree common prefix.
The chunks are zstd frames (the ``.zarray``'s compressor) of the array's
bytes in its order; ``bfloat16`` is read as uint16 and handed out as
``torch.bfloat16``, bit for bit.

zstd is ``libzstd.so.1`` bound with ``ctypes`` (its streaming API: OCDBT's and
zarr's frames may omit their content size). A missing library, a bad
checksum or a malformed file raises ``CheckpointError`` naming the file.
"""

from __future__ import annotations

import ctypes
import json
import math
import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_OFFSET = 2 ** 64 - 1  # an empty tree's root reference


class CheckpointError(ValueError):
    """A JAX checkpoint that cannot be read: corrupt, truncated, or of a
    format this reader does not know."""


# --- CRC-32C (Castagnoli, reflected polynomial 0x82f63b78) -------------------

def _crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --- zstd through libzstd --------------------------------------------------

class _Buffer(ctypes.Structure):  # ZSTD_inBuffer and ZSTD_outBuffer alike
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_zstd_lib = None


def _zstd():
    global _zstd_lib
    if _zstd_lib is None:
        try:
            lib = ctypes.CDLL("libzstd.so.1")
        except OSError as e:
            raise CheckpointError(f"reading a JAX checkpoint needs libzstd.so.1: {e}") from e
        lib.ZSTD_createDCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_freeDCtx.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Buffer),
                                              ctypes.POINTER(_Buffer)]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
        _zstd_lib = lib
    return _zstd_lib


def zstd_decompress(src: bytes, size: int | None, where: str, limit: int = 1 << 34) -> bytearray:
    """The frames of ``src`` decompressed: into exactly ``size`` bytes where
    the caller knows the size (a zarr chunk), else into as many as the frames
    hold (at most ``limit``). ``where`` names the file in errors."""
    lib = _zstd()
    src_arr = np.frombuffer(src, np.uint8)
    inb = _Buffer(src_arr.ctypes.data, src_arr.size, 0)
    step = lib.ZSTD_DStreamOutSize() if size is None else size
    out = bytearray(max(step, 1))
    outb = _Buffer(0, 0, 0)
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx")
    try:
        while True:
            if outb.pos == len(out) and size is None:
                if len(out) >= limit:
                    raise CheckpointError(f"{where}: zstd data longer than {limit} bytes")
                out.extend(bytes(min(len(out), limit - len(out))))
            dst = (ctypes.c_char * len(out)).from_buffer(out)
            outb.ptr, outb.size = ctypes.addressof(dst), len(out)
            before = inb.pos, outb.pos
            ret = lib.ZSTD_decompressStream(dctx, ctypes.byref(outb), ctypes.byref(inb))
            del dst
            if lib.ZSTD_isError(ret):
                raise CheckpointError(f"{where}: zstd: {lib.ZSTD_getErrorName(ret).decode()}")
            if ret == 0 and inb.pos == inb.size:
                break
            if (inb.pos, outb.pos) == before:
                raise CheckpointError(f"{where}: zstd data longer than {size} bytes"
                                      if outb.pos == len(out) else f"{where}: zstd frame "
                                      "truncated")
    finally:
        lib.ZSTD_freeDCtx(dctx)
    if size is not None and outb.pos != size:
        raise CheckpointError(f"{where}: zstd data of {outb.pos} bytes, not {size}")
    del out[outb.pos:]
    return out


# --- OCDBT -----------------------------------------------------------------

class _Cursor:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what):
        raise CheckpointError(f"{self.where}: {what} at byte {self.pos}")

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int):
        return [self.varint() for _ in range(n)]


def _envelope(data: bytes, magic: int, where: str, limit: int) -> bytes:
    """The body of one manifest or node envelope, its checksum checked."""
    if len(data) < 18:
        raise CheckpointError(f"{where}: {len(data)} bytes, too short")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise CheckpointError(f"{where}: magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(data):
        raise CheckpointError(f"{where}: length {length}, but {len(data)} bytes")
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise CheckpointError(f"{where}: CRC-32C mismatch")
    c = _Cursor(data[:-4], where)
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0 or compression not in (0, 1):
        c.fail(f"version {version}, compression {compression}")
    body = data[c.pos:-4]
    return zstd_decompress(body, None, where, limit) if compression else body


def _data_file_table(c: _Cursor):
    """The data files a manifest or node refers to, as paths relative to
    the store's root (``base_path + relative_path``)."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for p, s, b in zip(prefix, suffix, base):
        full = prev[:p] + c.raw(s)
        if b > len(full):
            c.fail("base path longer than the path")
        paths.append(full.decode())
        prev = full
    return paths


def _keys(c: _Cursor, n: int, with_subtree_prefix: bool):
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if with_subtree_prefix else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            c.fail("key prefix longer than the previous key")
        prev = prev[:p] + c.raw(s)
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The key-value store under ``root`` as it stands at its manifest's
    newest version: ``keys()`` and ``read(key)`` (bytes)."""

    def __init__(self, root):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        where = str(manifest)
        try:
            raw = manifest.read_bytes()
        except OSError as e:
            raise CheckpointError(f"{where}: {e}") from e
        c = _Cursor(_envelope(raw, MANIFEST_MAGIC, where, 1 << 30), where)
        c.raw(16)  # the store's uuid
        kind = c.varint()
        c.varint()  # max_inline_value_bytes
        self.max_node = c.varint()
        c.byte()  # version_tree_arity_log2
        if c.varint() == 1:
            c.raw(4)  # zstd level, int32
        if kind != 0:
            c.fail(f"manifest kind {kind} (numbered manifests are not read)")
        files = _data_file_table(c)
        n = c.varint()
        if not n:
            c.fail("no version")
        generation, height = c.varints(n), c.varints(n)
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        num_keys = c.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        self.values: Dict[bytes, Tuple] = {}
        if num_keys[newest] and offset[newest] != _NO_OFFSET:
            self._node(files, file_id[newest], offset[newest], length[newest],
                       height[newest], b"")
        if len(self.values) != num_keys[newest]:
            raise CheckpointError(f"{where}: {len(self.values)} keys in the tree, the "
                                  f"manifest says {num_keys[newest]}")

    def _file(self, files, i, where) -> Path:
        if i >= len(files):
            raise CheckpointError(f"{where}: data file {i} of {len(files)}")
        return self.root / files[i]

    def _slice(self, path: Path, offset: int, length: int) -> bytes:
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except OSError as e:
            raise CheckpointError(f"{path}: {e}") from e
        if len(data) != length:
            raise CheckpointError(f"{path}: {length} bytes at {offset} asked, {len(data)} read")
        return data

    def _node(self, files, i, offset, length, height, prefix: bytes):
        path = self._file(files, i, str(self.root / "manifest.ocdbt"))
        where = f"{path}@{offset}"
        c = _Cursor(_envelope(self._slice(path, offset, length), NODE_MAGIC, where,
                              max(self.max_node, 1 << 20)), where)
        if c.byte() != height:
            c.fail(f"node height differs from its reference's {height}")
        files = _data_file_table(c)
        n = c.varint()
        if height:
            keys, common = _keys(c, n, True)
            child_file, child_off, child_len = c.varints(n), c.varints(n), c.varints(n)
            for k, p, f, o, ln in zip(keys, common, child_file, child_off, child_len):
                self._node(files, f, o, ln, height - 1, prefix + k[:p])
            return
        keys, _ = _keys(c, n, False)
        lengths, kinds = c.varints(n), c.varints(n)
        outside = [j for j, k in enumerate(kinds) if k == 1]
        if any(k not in (0, 1) for k in kinds):
            c.fail(f"value kinds {sorted(set(kinds))}")
        ids, offsets = c.varints(len(outside)), c.varints(len(outside))
        refs = dict(zip(outside, zip(ids, offsets)))
        for j, (k, ln) in enumerate(zip(keys, lengths)):
            if j in refs:
                f, o = refs[j]
                self.values[prefix + k] = (self._file(files, f, where), o, ln)
            else:
                self.values[prefix + k] = (c.raw(ln),)

    def keys(self):
        return self.values.keys()

    def read(self, key) -> bytes:
        key = key.encode() if isinstance(key, str) else key
        try:
            ref = self.values[key]
        except KeyError:
            raise CheckpointError(f"{self.root}: no key {key.decode()!r}") from None
        return ref[0] if len(ref) == 1 else self._slice(*ref)


# --- zarr v2 arrays ---------------------------------------------------------

def _dtype(name: str, where: str):
    """(numpy dtype of the stored bytes, torch dtype handed out)."""
    if name == "bfloat16":
        return np.dtype("<u2"), torch.bfloat16
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise CheckpointError(f"{where}: dtype {name!r}") from e
    return dt, None


def read_array(store: OcdbtStore, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store`` as a CPU tensor."""
    where = f"{store.root}:{name}"
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise CheckpointError(f"{where}: zarr format {meta.get('zarr_format')}, filters "
                              f"{meta.get('filters')}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise CheckpointError(f"{where}: compressor {compressor}")
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    dt, as_torch = _dtype(meta["dtype"], where)
    order, sep = meta.get("order", "C"), meta.get("dimension_separator", ".")
    if meta.get("fill_value") not in (None, 0):
        raise CheckpointError(f"{where}: fill value {meta['fill_value']}")
    out = np.zeros(shape, dt)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dt.itemsize
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key.encode() not in store.values:
            continue  # a chunk of zeros (the fill value) that the writer left out
        data = store.read(key)
        if compressor is not None:
            data = zstd_decompress(data, chunk_bytes, key)
        elif len(data) != chunk_bytes:
            raise CheckpointError(f"{where}: chunk {key} of {len(data)} bytes")
        block = np.frombuffer(data, dt).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    t = torch.from_numpy(out)
    return t.view(as_torch) if as_torch is not None else t


# --- the tree ---------------------------------------------------------------

def _set(tree, keys, value):
    """Place ``value`` at the key path ``keys`` ((key, key_type) pairs),
    making dicts for dict keys and lists for sequence indices."""
    node = tree
    for depth, (key, _) in enumerate(keys):
        last = depth == len(keys) - 1
        nxt = keys[depth + 1][1] if not last else None
        if isinstance(node, list):
            key = int(key)
            while len(node) <= key:
                node.append(None)
        if last:
            node[key] = value
        else:
            if (node[key] if isinstance(node, list) else node.get(key)) is None:
                node[key] = [] if nxt == 1 else {}
            node = node[key]
    return tree


def read_checkpoint(path) -> dict:
    """The tree of the JAX checkpoint directory ``path``: dicts and lists as
    its metadata says, arrays as CPU tensors (``bfloat16`` as
    ``torch.bfloat16``), strings, Python scalars and ``None``."""
    path = Path(path)
    try:
        meta = json.loads((path / "_METADATA").read_text())
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{path / '_METADATA'}: {e}") from e
    strings = {}
    if (path / "_strings.json").exists():
        strings = json.loads((path / "_strings.json").read_text())
    store = OcdbtStore(path)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        name = ".".join(k for k, _ in keys)
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            value = None
        elif kind == "string":
            value = strings[name]
        elif kind in ("np.ndarray", "jax.Array", "scalar"):
            value = read_array(store, name)
            if kind == "scalar":
                value = value.item()
        elif kind in ("Dict", "List", "Tuple"):  # an empty container
            value = {} if kind == "Dict" else []
        else:
            raise CheckpointError(f"{path}: leaf {name} of value type {kind!r}")
        _set(tree, keys, value)
    return tree


def is_jax_checkpoint(path) -> bool:
    """A JAX checkpoint is a directory (the port's own is a file)."""
    return Path(path).is_dir()
