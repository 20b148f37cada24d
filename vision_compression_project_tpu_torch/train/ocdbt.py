"""Reader of the orbax checkpoints the repo ships, with no jax, orbax,
tensorstore or zstandard: the counterpart of
`ocp.StandardCheckpointer().restore` for a checkpoint of f32 and bfloat16
arrays.

A checkpoint directory holds an OCDBT key-value store (`manifest.ocdbt`, B-tree
nodes and data files) of zarr v2 arrays, one per parameter: `<name>/.zarray`
(the JSON metadata) and `<name>/<i>.<j>...` (chunks, zstd-compressed), with
`_METADATA` mapping each dotted name to its path in the parameter tree.

OCDBT layout, as written by tensorstore (every integer a LEB128 varint unless
said otherwise):

  file        = magic (4 bytes, big-endian) | length (u64 LE, the whole file)
                | version | compression (0 none, 1 zstd) | body | CRC-32C (u32 LE)
                of everything before it
  manifest    = magic 0x0cdb3a2a; body = config | data-file table | versions
                | version-tree nodes
  config      = uuid (16 bytes) | manifest kind (0 single) | max inline value
                bytes | max decoded node bytes | version-tree arity log2 (1 byte)
                | compression (+ zstd level) | three data-file prefixes (strings)
  versions    = n | generation[n] | root height[n] (1 byte each) | root file
                id[n] | offset[n] | length[n] | num keys[n] | tree bytes[n]
                | indirect value bytes[n] | commit time[n] (u64 LE)
  node        = magic 0x0cdb20de; body = height (1 byte) | data-file table | n
                | key prefix length[n-1] | key suffix length[n]
                | (interior: subtree common prefix length[n]) | key suffixes
                then, in a leaf: value length[n] | value kind[n] (1 byte: 0
                inline, 1 in a data file) | file id[m] | offset[m] for the m
                out-of-line values | the inline values, concatenated;
                in an interior node: child file id[n] | offset[n] | length[n]
                | num keys[n] | tree bytes[n] | indirect value bytes[n]
  data-file table = n | path prefix length[n-1] (shared with the previous
                path) | path suffix length[n] | base path length[n] | suffixes;
                a file lies at <store root>/<path>

A key in a node is relative to the key prefix its parent entry passes down.
A root offset of 2**64 - 1 is the empty tree.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..native import ZstdError, crc32c, zstd_decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_EMPTY = (1 << 64) - 1

class CheckpointError(ValueError):
    """A checkpoint that is damaged or in a layout this reader does not take."""


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.i = 0

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.i >= len(self.data):
                raise CheckpointError("varint runs past the end of the body")
            b = self.data[self.i]
            self.i += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.data):
            raise CheckpointError("field runs past the end of the body")
        out = self.data[self.i : self.i + n]
        self.i += n
        return out

    def end(self, what: str) -> None:
        if self.i != len(self.data):
            raise CheckpointError(f"{len(self.data) - self.i} stray bytes after the {what}")


def _body(raw: bytes, magic: int, what: str) -> bytes:
    """Checks the header and CRC-32C of a manifest or node; returns its body."""
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        raise CheckpointError(f"{what}: bad magic number")
    (length,) = struct.unpack("<Q", raw[4:12])
    if length != len(raw):
        raise CheckpointError(f"{what}: header says {length} bytes, found {len(raw)}")
    (crc,) = struct.unpack("<I", raw[-4:])
    if crc32c(raw[:-4]) != crc:
        raise CheckpointError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(raw[:-4])
    cur.i = 12
    cur.varint()  # format version
    compression = cur.varint()
    payload = raw[cur.i : -4]
    if compression == 0:
        return payload
    if compression != 1:
        raise CheckpointError(f"{what}: unknown compression {compression}")
    try:
        return bytes(zstd_decompress(payload))
    except ZstdError as exc:
        raise CheckpointError(f"{what}: {exc}") from None


def _data_file_table(cur: _Cursor) -> List[str]:
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)  # base path lengths: the split does not change where a file lies
    paths, prev = [], b""
    for k in range(n):
        path = prev[: prefix[k]] + cur.take(suffix[k])
        paths.append(path.decode())
        prev = path
    return paths


def _keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys, prev = [], b""
    for k in range(n):
        key = prev[: prefix[k]] + cur.take(suffix[k])
        keys.append(key)
        prev = key
    return keys, common


class OcdbtStore:
    """Read-only OCDBT key-value store rooted at a directory."""

    def __init__(self, root):
        self.root = Path(root)
        self._files: Dict[str, int] = {}
        self._index: Optional[Dict[bytes, tuple]] = None

    def _read(self, path: str, offset: int, length: int) -> bytes:
        full = self.root / path
        try:
            size = self._files.get(path)
            if size is None:
                size = self._files[path] = os.path.getsize(full)
            if offset + length > size:
                raise CheckpointError(f"{path}: wants bytes {offset}..{offset + length}, file has {size}")
            with open(full, "rb") as f:
                f.seek(offset)
                return f.read(length)
        except OSError as exc:
            raise CheckpointError(f"cannot read {full}: {exc}") from None

    def _latest_root(self) -> Optional[tuple]:
        raw = self._read("manifest.ocdbt", 0, os.path.getsize(self.root / "manifest.ocdbt"))
        cur = _Cursor(_body(raw, MANIFEST_MAGIC, "manifest.ocdbt"))
        cur.take(16)  # uuid
        if cur.varint() != 0:
            raise CheckpointError("numbered manifests are not supported")
        cur.varints(2)  # max inline value bytes, max decoded node bytes
        cur.take(1)  # version-tree arity log2
        if cur.varint() == 1:
            cur.varint()  # zstd level
        for _ in range(3):  # data-file prefixes
            cur.take(cur.varint())
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            return None
        cur.varints(n)  # generations
        heights = list(cur.take(n))
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)  # statistics
        cur.take(8 * n)  # commit times
        # The newest version is the last inline one; older ones may sit in
        # version-tree nodes, which nothing here needs.
        if off[-1] == _EMPTY:
            return None
        return heights[-1], files[fid[-1]], off[-1], length[-1]

    def _walk(self, path: str, offset: int, length: int, prefix: bytes, out: Dict[bytes, tuple]) -> None:
        body = _body(self._read(path, offset, length), NODE_MAGIC, f"B-tree node in {path}@{offset}")
        cur = _Cursor(body)
        height = cur.take(1)[0]
        files = _data_file_table(cur)
        n = cur.varint()
        keys, common = _keys(cur, n, interior=height > 0)
        if height > 0:
            fid, off, size = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # statistics
            cur.end("interior node")
            for k in range(n):
                self._walk(files[fid[k]], off[k], size[k], prefix + keys[k][: common[k]], out)
            return
        lengths = cur.varints(n)
        kinds = list(cur.take(n))
        if any(k > 1 for k in kinds):
            raise CheckpointError(f"unknown value kind in {path}@{offset}")
        indirect = [k for k in range(n) if kinds[k] == 1]
        fid, off = cur.varints(len(indirect)), cur.varints(len(indirect))
        for k in range(n):
            if kinds[k] == 0:
                out[prefix + keys[k]] = ("inline", cur.take(lengths[k]))
        cur.end("leaf node")
        for j, k in enumerate(indirect):
            out[prefix + keys[k]] = (files[fid[j]], off[j], lengths[k])

    def index(self) -> Dict[bytes, tuple]:
        if self._index is None:
            root = self._latest_root()
            self._index = {}
            if root is not None:
                _, path, offset, length = root
                self._walk(path, offset, length, b"", self._index)
        return self._index

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self.index())

    def read(self, key: str) -> Optional[bytes]:
        ref = self.index().get(key.encode())
        if ref is None:
            return None
        if ref[0] == "inline":
            return ref[1]
        return self._read(*ref)


# zarr dtypes this reader takes: (bytes an element, how the bytes become an array).
_ZARR_DTYPES = {
    "<f4": (4, lambda data, shape: np.frombuffer(data, np.float32).reshape(shape)),
    # numpy has no bfloat16 of its own: a torch tensor, from the 16-bit patterns.
    "bfloat16": (2, lambda data, shape: torch.from_numpy(
        np.frombuffer(data, np.int16).reshape(shape).copy()).view(torch.bfloat16)),
}


def _read_array(store: OcdbtStore, name: str):
    """One array as orbax writes it: zarr v2, C order, one chunk holding the
    whole array, zstd-compressed; f32 as a numpy array, bfloat16 (a bf16
    model's expert weights) as a CPU torch.bfloat16 tensor."""
    meta_raw = store.read(f"{name}/.zarray")
    if meta_raw is None:
        raise CheckpointError(f"no array {name!r} in the checkpoint")
    meta = json.loads(meta_raw)
    shape = tuple(meta["shape"])
    layout = (meta.get("zarr_format"), meta.get("dtype"), meta.get("order"), meta.get("filters"),
              (meta.get("compressor") or {}).get("id"), tuple(meta["chunks"]))
    if layout[1] not in _ZARR_DTYPES or layout[:1] + layout[2:] != (2, "C", None, "zstd", shape):
        raise CheckpointError(f"{name}: zarr layout {layout} is not one this reader takes")
    itemsize, to_array = _ZARR_DTYPES[layout[1]]
    key = meta.get("dimension_separator", ".").join("0" * len(shape)) if shape else "0"
    raw = store.read(f"{name}/{key}")
    if raw is None:
        raise CheckpointError(f"{name}: chunk {key} is missing")
    try:
        data = zstd_decompress(raw, itemsize * int(np.prod(shape, dtype=np.int64)))
    except ZstdError as exc:
        raise CheckpointError(f"{name}/{key}: {exc}") from None
    return to_array(data, shape)


def read_checkpoint(path, subtree: Tuple[str, ...] = ()) -> Dict:
    """Restore an orbax checkpoint directory into nested dicts of numpy
    arrays, the layout `weights.params_from_jax` takes. `subtree` keeps only
    the leaves under that key path, e.g. ("0",) for the params of a saved
    TrainState, and strips it from the result."""
    path = Path(path)
    try:
        tree_meta = json.loads((path / "_METADATA").read_text())["tree_metadata"]
    except (OSError, ValueError, KeyError) as exc:
        raise CheckpointError(f"{path}: unreadable _METADATA ({exc})") from None
    store = OcdbtStore(path)
    out: Dict = {}
    for entry in tree_meta.values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        if keys[: len(subtree)] != tuple(subtree):
            continue
        node = out
        rel = keys[len(subtree):]
        for k in rel[:-1]:
            node = node.setdefault(k, {})
        node[rel[-1]] = _read_array(store, ".".join(keys))
    if not out:
        raise CheckpointError(f"{path}: no arrays under {'.'.join(subtree) or 'the root'}")
    return out
