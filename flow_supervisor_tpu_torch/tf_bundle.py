"""A reader of TensorFlow's tensor-bundle checkpoints in numpy, without
TensorFlow (the format ``tf.train.Checkpoint.write`` and ``tf.train.load_checkpoint``
use): ``<prefix>.index`` and ``<prefix>.data-NNNNN-of-MMMMM``.

- The index is a LevelDB-format table: a 48-byte footer (the metaindex and
  index block handles as varints, padding, the magic 0xdb4775248b80fb57),
  an index block whose values are the handles of the data blocks, and data
  blocks of prefix-compressed keys closed by a restart array; every block
  is followed by a 5-byte trailer (compression type, CRC). Only
  uncompressed blocks (type 0, what TensorFlow writes) are read.
- The entry under the empty key is the ``BundleHeaderProto`` (the number
  of data shards); every other value is a ``BundleEntryProto``: dtype (1),
  shape (2, its dims' sizes), shard_id (3), offset (4) and size (5), read by
  a minimal protobuf reader. Its bytes are little-endian at that offset of
  that shard.

``BundleReader(prefix)`` has ``get_variable_to_shape_map()`` and
``get_tensor(name)`` as TensorFlow's ``CheckpointReader`` does. float32,
float16, int32 and int64 tensors are read (``get_tensor`` raises for other
dtypes); string entries (``_CHECKPOINTABLE_OBJECT_GRAPH``) are listed in
``string_keys`` and skipped; sliced (partitioned) tensors raise.
"""
from __future__ import annotations

import struct

import numpy as np

_MAGIC = 0xDB4775248B80FB57
_FOOTER = 48
_TRAILER = 5
# TensorFlow DataType enum -> numpy dtype
_DTYPES = {1: np.float32, 3: np.int32, 9: np.int64, 19: np.float16}
_DT_STRING = 7


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out, shift = 0, 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: an int for
    varints and fixed-width fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            (val,), pos = struct.unpack_from("<Q", buf, pos), pos + 8
        elif wire == 5:
            (val,), pos = struct.unpack_from("<I", buf, pos), pos + 4
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos : pos + n], pos + n
        else:
            raise ValueError(f"protobuf wire type {wire} is not read")
        yield num, wire, val


def _block(data: bytes, offset: int, size: int, what: str) -> bytes:
    if offset + size + _TRAILER > len(data):
        raise ValueError(f"{what}: block at {offset} runs past the end of the index")
    kind = data[offset + size]
    if kind != 0:
        raise ValueError(f"{what}: block compression type {kind} is not read (only 0, none)")
    return data[offset : offset + size]


def _entries(block: bytes):
    """(key, value) pairs of one table block."""
    (restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 * (restarts + 1)
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos : pos + unshared]
        pos += unshared
        yield key, block[pos : pos + vlen]
        pos += vlen


def read_index(path: str) -> dict[bytes, bytes]:
    """Every (key, value) of a LevelDB-format table file, over all its data blocks."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER:
        raise ValueError(f"{path}: too short for a table footer")
    footer = data[-_FOOTER:]
    (magic,) = struct.unpack_from("<Q", footer, _FOOTER - 8)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a tensor-bundle index (bad table magic)")
    _, pos = _varint(footer, 0)  # metaindex handle: offset, size
    _, pos = _varint(footer, pos)
    index_off, pos = _varint(footer, pos)
    index_size, pos = _varint(footer, pos)
    out = {}
    for _, handle in _entries(_block(data, index_off, index_size, path)):
        off, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        out.update(_entries(_block(data, off, size, path)))
    return out


class BundleReader:
    """The tensors of a checkpoint ``prefix`` (``<prefix>.index`` and its data files)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index = read_index(prefix + ".index")
        header = dict((n, v) for n, _, v in _fields(index.pop(b"", b"")))
        self.num_shards = header.get(1, 1)
        if header.get(2, 0) != 0:
            raise ValueError(f"{prefix}: a big-endian bundle is not read")
        self.entries, self.string_keys = {}, []
        for key, value in index.items():
            name = key.decode()
            entry = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0}
            for num, _, val in _fields(value):
                if num == 1:
                    entry["dtype"] = val
                elif num == 2:
                    entry["shape"] = [dict((n, v) for n, _, v in _fields(dim)).get(1, 0)
                                      for n2, _, dim in _fields(val) if n2 == 2]
                elif num in (3, 4, 5):
                    entry[{3: "shard_id", 4: "offset", 5: "size"}[num]] = val
                elif num == 7:
                    raise ValueError(f"{prefix}: {name} is a sliced tensor, which is not read")
            if entry["dtype"] == _DT_STRING:
                self.string_keys.append(name)
            else:
                self.entries[name] = entry
        self._shards: dict[int, bytes] = {}

    def _shard(self, i: int) -> bytes:
        if i not in self._shards:
            with open(f"{self.prefix}.data-{i:05d}-of-{self.num_shards:05d}", "rb") as f:
                self._shards[i] = f.read()
        return self._shards[i]

    def get_variable_to_shape_map(self) -> dict[str, list[int]]:
        return {k: list(e["shape"]) for k, e in self.entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        if e["dtype"] not in _DTYPES:
            raise ValueError(f"{self.prefix}: {name} has TensorFlow dtype {e['dtype']}, "
                             "which is not read (float32, float16, int32, int64)")
        raw = self._shard(e["shard_id"])[e["offset"] : e["offset"] + e["size"]]
        if len(raw) != e["size"]:
            raise ValueError(f"{self.prefix}: {name} runs past the end of its data file")
        arr = np.frombuffer(raw, np.dtype(_DTYPES[e["dtype"]]).newbyteorder("<"))
        return arr.reshape(e["shape"]).astype(arr.dtype.newbyteorder("="))
