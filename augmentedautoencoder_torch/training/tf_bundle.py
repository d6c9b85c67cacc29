"""Read TensorFlow's V2 checkpoints with numpy alone (no TensorFlow).

A checkpoint `<prefix>` is `<prefix>.index`, a LevelDB-format table, and
the tensors' bytes in `<prefix>.data-<shard:05d>-of-<num:05d>`:

  * the index ends in a 48-byte footer: the metaindex and the index
    blocks' handles (varint64 offset, varint64 size), zero padding, and
    the magic 0xdb4775248b80fb57 (fixed64, little-endian);
  * the index block maps each data block's last key to its handle; a
    block is a run of prefix-compressed entries (varint32 shared,
    non-shared and value lengths, the key's new bytes, the value), then a
    restart array (uint32 offsets and their uint32 count), then a 5-byte
    trailer: its compression type (0: none) and a masked crc32c;
  * key "" holds the BundleHeaderProto (num_shards field 1, endianness 2),
    every other key a tensor name with its BundleEntryProto: dtype (1),
    shape (2: TensorShapeProto, dims field 2, each with its size in field
    1), shard_id (3), offset (4), size (5), crc32c (6), slices (7).

The reader decodes just these two messages (`_fields`, a minimal protobuf
decoder), reads float32, float64, int32 and int64 tensors, little-endian,
and checks each tensor's byte size against its shape. It refuses a
compressed block, a truncated or malformed index, a big-endian bundle, a
sliced (partitioned) tensor, and a requested tensor of any other dtype.
Neither the blocks' nor the tensors' crc32c is checked.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
# TensorFlow's DataType enum -> numpy dtype (little-endian)
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"), 9: np.dtype("<i8")}


class CheckpointFormatError(ValueError):
    """The checkpoint is not a V2 bundle this reader can read."""


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, next position) of the varint at buf[pos]."""
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise CheckpointFormatError("truncated varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise CheckpointFormatError("varint longer than 64 bits")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a protobuf message:
    an int for varints and fixed-width fields, bytes for length-delimited
    ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise CheckpointFormatError(f"unsupported protobuf wire type {wire}")
        if pos > len(buf):
            raise CheckpointFormatError("truncated protobuf message")
        yield field, wire, value


def _block(data: bytes, offset: int, size: int) -> bytes:
    """The contents of the block at (offset, size), its trailer checked for
    no compression."""
    end = offset + size + BLOCK_TRAILER_BYTES
    if offset < 0 or end > len(data):
        raise CheckpointFormatError(f"block ({offset}, {size}) runs past the index's {len(data)} bytes")
    if data[offset + size] != 0:
        raise CheckpointFormatError(f"block at {offset} is compressed (type {data[offset + size]}); "
                                    "only uncompressed tables are read")
    return data[offset:offset + size]


def _entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of each entry of a table block."""
    if len(block) < 4:
        raise CheckpointFormatError("block too short for its restart count")
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise CheckpointFormatError("block's restart array runs past its start")
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        if shared > len(key) or pos + non_shared + n_value > end:
            raise CheckpointFormatError("malformed block entry")
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + n_value]
        pos += n_value


def _handle(buf: bytes, pos: int = 0) -> Tuple[Tuple[int, int], int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return (offset, size), pos


def _read_table(path: str) -> Dict[bytes, bytes]:
    """Every (key, value) of the table in `path`."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < FOOTER_BYTES:
        raise CheckpointFormatError(f"{path}: {len(data)} bytes, shorter than a table footer")
    footer = data[-FOOTER_BYTES:]
    if struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)[0] != MAGIC:
        raise CheckpointFormatError(f"{path}: no table magic in its footer (truncated or not a checkpoint index)")
    _, pos = _handle(footer)
    (index_offset, index_size), _ = _handle(footer, pos)
    table = {}
    for _, handle in _entries(_block(data, index_offset, index_size)):
        (offset, size), _ = _handle(handle)
        table.update(_entries(_block(data, offset, size)))
    return table


def _entry(name: str, value: bytes) -> Dict:
    """A BundleEntryProto as a dict (dtype, shape, shard_id, offset, size, sliced)."""
    entry = {"name": name, "dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0, "sliced": False}
    for field, _, v in _fields(value):
        if field == 1:
            entry["dtype"] = v
        elif field == 2:
            for f, _, dim in _fields(v):
                if f == 2:
                    entry["shape"].append(next((s for g, _, s in _fields(dim) if g == 1), 0))
                elif f == 3 and dim:
                    raise CheckpointFormatError(f"{name}: shape of unknown rank")
        elif field in (3, 4, 5):
            entry[("shard_id", "offset", "size")[field - 3]] = v
        elif field == 7:
            entry["sliced"] = True
    return entry


def resolve_prefix(ckpt_path: str) -> str:
    """The checkpoint prefix of `ckpt_path`: itself, or for a directory the
    newest one its `checkpoint` file names (model_checkpoint_path)."""
    if not os.path.isdir(ckpt_path):
        return ckpt_path
    state = os.path.join(ckpt_path, "checkpoint")
    if not os.path.exists(state):
        raise FileNotFoundError(f"{ckpt_path} is a directory without a `checkpoint` file")
    with open(state) as fh:
        for line in fh:
            key, _, value = line.partition(":")
            if key.strip() == "model_checkpoint_path":
                prefix = value.strip().strip('"')
                return prefix if os.path.isabs(prefix) else os.path.join(ckpt_path, prefix)
    raise FileNotFoundError(f"{state} names no model_checkpoint_path")


class TFCheckpointReader:
    """The tensors of one V2 checkpoint: `names()` and `tensor(name)` (a
    numpy array)."""

    def __init__(self, ckpt_path: str):
        self.prefix = resolve_prefix(ckpt_path)
        table = _read_table(self.prefix + ".index")
        if b"" not in table:
            raise CheckpointFormatError(f"{self.prefix}.index holds no bundle header")
        header = {f: v for f, _, v in _fields(table.pop(b""))}
        if header.get(2, 0) != 0:
            raise CheckpointFormatError(f"{self.prefix}: a big-endian bundle")
        self.num_shards = header.get(1, 1)
        self._entries = {k.decode(): _entry(k.decode(), v) for k, v in table.items()}

    def names(self):
        return sorted(self._entries)

    def tensor(self, name: str) -> np.ndarray:
        e = self._entries[name]
        if e["sliced"]:
            raise CheckpointFormatError(f"{name} is sliced (a partitioned variable): not read")
        if e["dtype"] not in DTYPES:
            raise CheckpointFormatError(f"{name} has TensorFlow dtype {e['dtype']}: only float32, float64, "
                                        "int32 and int64 are read")
        dtype = DTYPES[e["dtype"]]
        count = int(np.prod(e["shape"], dtype=np.int64))
        if e["size"] != count * dtype.itemsize:
            raise CheckpointFormatError(f"{name}: {e['size']} bytes for shape {e['shape']} of {dtype}")
        path = f"{self.prefix}.data-{e['shard_id']:05d}-of-{self.num_shards:05d}"
        with open(path, "rb") as fh:
            fh.seek(e["offset"])
            raw = fh.read(e["size"])
        if len(raw) != e["size"]:
            raise CheckpointFormatError(f"{name}: {path} ends before its {e['size']} bytes at {e['offset']}")
        return np.frombuffer(raw, dtype).reshape(e["shape"]).astype(dtype.newbyteorder("="))


def load_tf_checkpoint_variables(ckpt_path: str, scope: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Every variable of the checkpoint (with `scope`, those under it, the
    scope and its slash stripped from the names), as the JAX package's
    `load_tf_checkpoint_variables` returns them."""
    reader = TFCheckpointReader(ckpt_path)
    out = {}
    for name in reader.names():
        if scope and not name.startswith(scope + "/"):
            continue
        out[name[len(scope) + 1:] if scope else name] = reader.tensor(name)
    return out
