"""The HDF5 subset that keras weight files use, read and written with numpy,
so the port loads and saves ``.h5`` weights without ``h5py`` (the GPU
machine has none).

Reads what libhdf5 writes by default (``h5py`` at ``libver="earliest"``):

- superblock versions 0 and 1, 8-byte offsets and lengths, a user block;
- version-1 object headers, their continuation blocks (message 0x10)
  followed in order;
- old-style groups (symbol-table message 0x11): version-1 group B-trees
  of any depth, their SNOD nodes and the local heap of names;
- dataspace messages versions 1 and 2 (rank 0 is a scalar);
- fixed-point (class 0) and IEEE float (class 1) datatypes of 1 to 8
  bytes, either byte order;
- layout message version 3, compact or contiguous; a contiguous dataset
  whose storage was never written reads as its fill value (message 0x05
  or 0x04; zeros without one).

Attribute messages and every other message type are skipped: the loader
needs groups and datasets only. Raises ``NotImplementedError``, naming the
object's path and the feature, on chunked or filtered layouts, external
storage, superblocks 2 and 3, version-2 object headers, new-style (link
message) groups, soft and external links, shared (committed) datatypes and
other datatype classes.

Writes superblock 0, version-1 object headers, old-style groups whose
names are sorted as libhdf5 sorts them (byte-wise) and contiguous
little-endian datasets, with no attributes. The group K values in the
superblock are chosen so that each group's entries fit one B-tree node.

Groups iterate in name order, as ``h5py``'s do. Addresses, lengths and
sizes below are little-endian.
"""

from __future__ import annotations

import math
import os
import struct
from collections.abc import Mapping
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "write_hdf5", "SIGNATURE", "READS"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
READS = ("HDF5 (superblock 0/1, version-1 object headers, symbol-table groups, "
         "contiguous or compact integer and IEEE float datasets)")
UNDEFINED = 0xFFFFFFFFFFFFFFFF
_HEAP_FREE_NULL = 1  # the local heap's "no free block" offset

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 6, 7, 8, 11, 16, 17

# the writer's group K values: up to 2 * _INTERNAL_K symbol nodes under one
# B-tree node (libhdf5's default K)
_INTERNAL_K = 16
_LEAF_K_MIN = 4
_BTREE_NODE = 24 + (2 * _INTERNAL_K) * 8 + (2 * _INTERNAL_K + 1) * 8
_ENTRY = 40  # a symbol-table entry


def _unsupported(path: str, feature: str):
    return NotImplementedError(
        f"{path}: {feature} is not supported (the port reads {READS})")


# ------------------------------------------------------------------ reading


class _Reader:
    """The file handle, its superblock, and the structures it points to."""

    def __init__(self, fh, name: str):
        self.fh = fh
        self.name = name
        self.base = self._find_signature()
        sb = self.read(0, 24)
        version = sb[8]
        if version not in (0, 1):
            raise _unsupported(name, f"superblock version {version}")
        if sb[13] != 8 or sb[14] != 8:
            raise _unsupported(name, f"{sb[13]}-byte offsets and {sb[14]}-byte lengths")
        at = 24 if version == 0 else 28  # version 1: indexed-storage K, reserved
        self.root = self.entry(self.read(at + 32, _ENTRY), 0)[0]

    def _find_signature(self) -> int:
        """The superblock sits at 0 or after a user block of 512 * 2**n bytes."""
        size = self.fh.seek(0, os.SEEK_END)
        at = 0
        while at + 8 <= size:
            self.fh.seek(at)
            if self.fh.read(8) == SIGNATURE:
                return at
            at = 512 if at == 0 else 2 * at
        raise ValueError(f"{self.name}: not an HDF5 file")

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(self.base + addr)
        data = self.fh.read(n)
        if len(data) != n:
            raise ValueError(f"{self.name}: truncated at address {addr}")
        return data

    def read_into(self, addr: int, buf) -> None:
        self.fh.seek(self.base + addr)
        if self.fh.readinto(buf) != len(buf):
            raise ValueError(f"{self.name}: truncated at address {addr}")

    @staticmethod
    def entry(data: bytes, at: int) -> Tuple[int, int, int]:
        """A symbol-table entry -> (object header address, name offset,
        cache type)."""
        name_off, header, cache = struct.unpack_from("<QQI", data, at)
        return header, name_off, cache

    def messages(self, addr: int, path: str):
        """A version-1 object header -> [(type, flags, body)], continuation
        blocks followed in order (the continuation messages themselves are
        not returned)."""
        prefix = self.read(addr, 16)
        if prefix[:4] == b"OHDR":
            raise _unsupported(path, "a version-2 object header")
        if prefix[0] != 1:
            raise ValueError(f"{path}: bad object header version {prefix[0]}")
        count, size = struct.unpack_from("<H", prefix, 2)[0], struct.unpack_from("<I", prefix, 8)[0]
        blocks = [(addr + 16, size)]
        out, seen = [], 0
        while blocks and seen < count:
            start, length = blocks.pop(0)
            buf = self.read(start, length)
            pos = 0
            while pos + 8 <= length and seen < count:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                body = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                seen += 1
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                elif mtype != _NIL:
                    out.append((mtype, mflags, body))
        return out

    def heap(self, addr: int, path: str) -> bytes:
        """A local heap's data segment."""
        head = self.read(addr, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{path}: bad local heap signature")
        size, _, data_addr = struct.unpack_from("<QQQ", head, 8)
        return self.read(data_addr, size)

    def group_entries(self, btree: int, heap: bytes, path: str, out: list) -> None:
        """Walk a version-1 group B-tree in key order, appending (name,
        header address, cache type) of every SNOD entry."""
        head = self.read(btree, 24)
        if head[:4] != b"TREE":
            raise ValueError(f"{path}: bad B-tree signature")
        node_type, level, used = head[4], head[5], struct.unpack_from("<H", head, 6)[0]
        if node_type != 0:
            raise ValueError(f"{path}: B-tree node type {node_type} in a group")
        body = self.read(btree + 24, used * 16 + 8)
        children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0] for i in range(used)]
        for child in children:
            if level > 0:
                self.group_entries(child, heap, path, out)
                continue
            snod = self.read(child, 8)
            if snod[:4] != b"SNOD":
                raise ValueError(f"{path}: bad symbol node signature")
            n = struct.unpack_from("<H", snod, 6)[0]
            entries = self.read(child + 8, n * _ENTRY)
            for i in range(n):
                header, name_off, cache = self.entry(entries, i * _ENTRY)
                name = heap[name_off:heap.index(b"\0", name_off)].decode("utf-8")
                out.append((name, header, cache))

    def node(self, addr: int, path: str):
        """The object at ``addr``: a Group or a Dataset."""
        msgs = self.messages(addr, path)
        types = {t for t, _, _ in msgs}
        if _SYMBOL_TABLE in types:
            return Group(self, path, dict(_by_type(msgs))[_SYMBOL_TABLE])
        if types & {_LINK_INFO, _LINK}:
            raise _unsupported(path, "a new-style (link message) group")
        if _LAYOUT in types:
            return Dataset(self, path, msgs)
        raise _unsupported(path, "an object that is neither a group nor a dataset")


def _by_type(msgs):
    for mtype, _, body in msgs:
        yield mtype, body


class Group(Mapping):
    """An old-style group: a Mapping from names, in libhdf5's (byte-wise)
    order, to Groups and Datasets, opened when indexed. ``group["a/b"]``
    walks the path."""

    def __init__(self, reader: _Reader, path: str, symbol_table: bytes):
        self._reader, self.name = reader, path
        btree, heap = struct.unpack_from("<QQ", symbol_table)
        entries: list = []
        reader.group_entries(btree, reader.heap(heap, path), path, entries)
        self._entries = {name: (header, cache) for name, header, cache in entries}

    def _child_path(self, key: str) -> str:
        return self.name.rstrip("/") + "/" + key

    def __getitem__(self, key: str):
        head, _, rest = key.partition("/")
        if head not in self._entries:
            raise KeyError(f"{self._child_path(head)}: no such object")
        header, cache = self._entries[head]
        path = self._child_path(head)
        if cache == 2:
            raise _unsupported(path, "a soft link")
        child = self._reader.node(header, path)
        return child[rest] if rest else child

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


def _dataspace(body: bytes, path: str) -> Tuple[int, ...]:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        at = 8
    elif version == 2:
        if body[3] == 2:
            raise _unsupported(path, "a null dataspace")
        at = 4
    else:
        raise _unsupported(path, f"dataspace message version {version}")
    return struct.unpack_from(f"<{rank}Q", body, at) if rank else ()


# (exponent size, mantissa size) of the IEEE formats numpy holds
_IEEE = {2: (5, 10), 4: (8, 23), 8: (11, 52)}


def _datatype(body: bytes, path: str) -> np.dtype:
    cls, bits, size = body[0] & 0x0F, body[1], struct.unpack_from("<I", body, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise _unsupported(path, f"a {precision}-bit integer in {size} bytes")
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        offset, precision, _, exp_size, _, mant_size = struct.unpack_from("<HHBBBB", body, 8)
        if bits & 0x40 or _IEEE.get(size) != (exp_size, mant_size) or offset \
                or precision != 8 * size:
            raise _unsupported(path, f"a non-IEEE {size}-byte float")
        return np.dtype(f"{order}f{size}")
    raise _unsupported(path, f"datatype class {cls}")


def _fill_value(msgs, dtype: np.dtype) -> Optional[bytes]:
    """The fill value's bytes (message 0x05, else 0x04), or None."""
    found = dict(_by_type(msgs))
    body = found.get(_FILL)
    if body is not None:
        version = body[0]
        if version in (1, 2):
            defined = version == 1 or body[3]
            at = 4
        else:  # version 3: flags in byte 1, bit 5 = fill value defined
            defined = body[1] & 0x20
            at = 2
        if defined:
            n = struct.unpack_from("<I", body, at)[0]
            return body[at + 4:at + 4 + n] if n == dtype.itemsize else None
        return None
    body = found.get(_FILL_OLD)
    if body is not None:
        n = struct.unpack_from("<I", body)[0]
        return body[4:4 + n] if n == dtype.itemsize else None
    return None


class Dataset:
    """A dataset: ``shape``, ``dtype`` (the file's byte order, as h5py
    gives it) and ``read()`` (also ``np.asarray(dataset)``)."""

    def __init__(self, reader: _Reader, path: str, msgs):
        self._reader, self.name = reader, path
        for mtype, mflags, _ in msgs:
            if mflags & 0x02 and mtype in (_DATASPACE, _DATATYPE, _LAYOUT, _FILL):
                raise _unsupported(path, "a shared (committed) message")
        found = dict(_by_type(msgs))
        if _FILTERS in found:
            raise _unsupported(path, "a filtered layout")
        if _EXTERNAL in found:
            raise _unsupported(path, "external storage")
        if _DATASPACE not in found or _DATATYPE not in found:
            raise ValueError(f"{path}: dataset without a dataspace or datatype")
        self.shape = tuple(int(d) for d in _dataspace(found[_DATASPACE], path))
        self.dtype = _datatype(found[_DATATYPE], path)
        layout = found[_LAYOUT]
        if layout[0] != 3:
            raise _unsupported(path, f"layout message version {layout[0]}")
        kind = layout[1]
        nbytes = self.dtype.itemsize * math.prod(self.shape)
        self._compact = self._addr = None
        if kind == 0:
            size = struct.unpack_from("<H", layout, 2)[0]
            self._compact = layout[4:4 + size]
            stored = size
        elif kind == 1:
            self._addr, stored = struct.unpack_from("<QQ", layout, 2)
        elif kind == 2:
            raise _unsupported(path, "a chunked layout")
        else:
            raise _unsupported(path, f"layout class {kind}")
        if stored != nbytes and not (kind == 1 and self._addr == UNDEFINED):
            raise ValueError(f"{path}: {stored} stored bytes for {self.shape} {self.dtype}")
        self._fill = _fill_value(msgs, self.dtype)

    def read(self) -> np.ndarray:
        if self._compact is not None:
            buf = bytearray(self._compact)
        elif self._addr == UNDEFINED:  # never written: the fill value
            if self._fill is None:
                return np.zeros(self.shape, self.dtype)
            fill = np.frombuffer(self._fill, self.dtype)[0]
            return np.full(self.shape, fill, self.dtype)
        else:
            arr = np.empty(self.shape, self.dtype)
            if arr.nbytes:
                self._reader.read_into(self._addr, memoryview(arr.reshape(-1)).cast("B"))
            return arr
        return np.frombuffer(buf, self.dtype).reshape(self.shape)

    def __array__(self, dtype=None, copy=None):
        arr = self.read()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self) -> str:
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self.dtype}>"


class File(Group):
    """An HDF5 file opened for reading: its root group. Close it (or use it
    in a ``with`` block) to release the file; datasets read from it stay."""

    def __init__(self, path):
        path = os.fspath(path)
        self._fh = open(path, "rb")
        try:
            reader = _Reader(self._fh, path)
            tables = dict(_by_type(reader.messages(reader.root, "/")))
            if _SYMBOL_TABLE not in tables:
                raise _unsupported(path, "a root group without a symbol table")
            super().__init__(reader, "/", tables[_SYMBOL_TABLE])
        except BaseException:
            self._fh.close()
            raise
        self.filename = path

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ writing


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _message(mtype: int, body: bytes) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f" and size in _IEEE:
        exp_size, mant_size = _IEEE[size]
        # little-endian, implied leading mantissa bit (normalization 2),
        # sign bit at the top
        return (struct.pack("<BBBBI", 0x11, 0x20, 8 * size - 1, 0, size)
                + struct.pack("<HHBBBBI", 0, 8 * size, mant_size, exp_size, 0,
                              mant_size, (1 << (exp_size - 1)) - 1))
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        return (struct.pack("<BBBBI", 0x10, 0x08 if dtype.kind == "i" else 0, 0, 0, size)
                + struct.pack("<HH", 0, 8 * size))
    raise TypeError(f"the HDF5 writer takes integer and IEEE float arrays, not {dtype}")


def _dataset_header(arr: np.ndarray, addr: int) -> bytes:
    space = struct.pack(f"<BBB5x{arr.ndim}Q", 1, arr.ndim, 0, *arr.shape)
    layout = struct.pack("<BBQQ", 3, 1, addr, arr.nbytes)
    return _object_header([_message(_DATASPACE, space),
                           _message(_DATATYPE, _datatype_message(arr.dtype)),
                           _message(_LAYOUT, layout)])


def _entry(name_off: int, header: int, cache: Optional[Tuple[int, int]]) -> bytes:
    if cache is None:
        return struct.pack("<QQII16x", name_off, header, 0, 0)
    return struct.pack("<QQIIQQ", name_off, header, 1, 0, *cache)


class _Writer:
    def __init__(self, fh, leaf_k: int):
        self.fh, self.leaf_k = fh, leaf_k

    def put(self, data) -> int:
        """Append ``data`` at the next 8-byte boundary -> its address."""
        at = _pad8(self.fh.tell())
        self.fh.seek(at)
        self.fh.write(data)
        return at

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.require(arr, arr.dtype.newbyteorder("<"), "C")  # keeps rank 0
        _datatype_message(arr.dtype)  # refuse other types before writing data
        addr = self.put(memoryview(arr).cast("B")) if arr.nbytes else UNDEFINED
        return self.put(_dataset_header(arr, addr))

    def group(self, tree: Mapping) -> Tuple[int, Tuple[int, int]]:
        """Children first, then the group's heap, symbol nodes, B-tree and
        header -> (header address, (B-tree, heap) addresses)."""
        names = sorted(tree, key=lambda k: k.encode("utf-8"))
        entries = []
        for name in names:
            if not name or "/" in name:
                raise ValueError(f"bad HDF5 member name {name!r}")
            value = tree[name]
            if isinstance(value, Mapping):
                entries.append(self.group(value))
            else:
                entries.append((self.dataset(np.asarray(value)), None))
        heap, offsets = bytearray(8), []  # offset 0: the empty name
        for name in names:
            offsets.append(len(heap))
            raw = name.encode("utf-8") + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        heap_data = self.put(bytes(heap))
        heap_addr = self.put(b"HEAP" + bytes(4)
                             + struct.pack("<QQQ", len(heap), _HEAP_FREE_NULL, heap_data))
        per_node = 2 * self.leaf_k
        keys, children = [0], []
        for start in range(0, len(names), per_node):
            chunk = range(start, min(start + per_node, len(names)))
            node = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(chunk)))
            for i in chunk:
                node += _entry(offsets[i], *entries[i])
            node += bytes(8 + per_node * _ENTRY - len(node))
            children.append(self.put(bytes(node)))
            keys.append(offsets[chunk[-1]])  # the largest name of the child
        tree_node = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(children),
                                                    UNDEFINED, UNDEFINED))
        for key, child in zip(keys, children):
            tree_node += struct.pack("<QQ", key, child)
        tree_node += struct.pack("<Q", keys[-1])
        tree_node += bytes(_BTREE_NODE - len(tree_node))
        btree = self.put(bytes(tree_node))
        header = self.put(_object_header(
            [_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))]))
        return header, (btree, heap_addr)


def _largest_group(tree: Mapping) -> int:
    return max([len(tree)] + [_largest_group(v) for v in tree.values()
                              if isinstance(v, Mapping)])


def write_hdf5(path, tree: Mapping) -> None:
    """Write a nested mapping of numpy arrays (integer or IEEE float) as an
    HDF5 file: mappings become groups, arrays contiguous little-endian
    datasets."""
    leaf_k = max(_LEAF_K_MIN, -(-_largest_group(tree) // (4 * _INTERNAL_K)))
    if leaf_k > 0xFFFF:
        raise ValueError("a group too large for one B-tree node")
    with open(os.fspath(path), "wb") as fh:
        fh.write(bytes(96))  # the superblock, written last
        writer = _Writer(fh, leaf_k)
        root, cache = writer.group(tree)
        eof = fh.seek(0, os.SEEK_END)
        fh.seek(0)
        fh.write(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                 + struct.pack("<HHI", leaf_k, _INTERNAL_K, 0)
                 + struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED)
                 + _entry(0, root, cache))
