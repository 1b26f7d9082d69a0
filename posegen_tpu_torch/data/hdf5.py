"""A small HDF5 reader and writer in numpy and the standard library, for the
files the data layer reads and writes (the port runs where h5py is absent).

What it reads is the subset of the format that h5py writes by default
(`libver="earliest"`):
  * superblock version 0, groups by symbol table (a version-1 B-tree of
    type 0, a local heap of names, SNOD symbol nodes), nested groups named
    "group/name";
  * version-1 object headers with continuation blocks;
  * dataspaces of any rank (rank 0: a scalar);
  * datatypes: fixed-point (signed and unsigned, either byte order), IEEE
    float 32 / 64, fixed-length strings, and variable-length strings
    through the global heap (read as an object array of bytes, as h5py does);
  * layouts (message version 3): contiguous, and chunked through a
    version-1 B-tree of type 1; storage that was never allocated reads as the
    fill value;
  * filters: deflate (zlib) and shuffle.
Anything else raises ValueError naming the dataset and what was met (a
superblock that is not at the file's start or is above version 0, a
version-2 object header, link messages, another layout, chunk index or
filter, another datatype). Nothing reads as zeros because it could not be
read.

`read_h5` returns every dataset as a numpy array, and the file offset of
each first-axis row of every unfiltered uint8 dataset whose rows are each one
contiguous byte range (contiguous layout, or one chunk per row): the data
layer mmaps the file and hands those rows to the native sampler.

`write_h5` writes a version-0 file with contiguous datasets that h5py (and
`read_h5`) read back to the same arrays.
"""

from __future__ import annotations

import dataclasses
import mmap
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_LAYOUT = 0x4, 0x5, 0x6, 0x8
MSG_GROUP_INFO, MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xA, 0xB, 0x10, 0x11
FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2


@dataclasses.dataclass
class DatasetInfo:
    """Where and how one dataset's elements are stored."""

    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype  # the array's dtype (object for variable-length strings)
    elem_size: int  # bytes per stored element
    vlen_str: bool
    layout: int  # 1 contiguous, 2 chunked
    address: Optional[int]  # absolute file offset; None when unallocated
    chunks: Optional[Tuple[int, ...]]  # chunked: elements per chunk, per axis
    filters: List[Tuple[int, Tuple[int, ...]]]  # (filter id, client data)
    fill: Optional[bytes]  # one element's fill value, None = zeros


class H5File:
    """One HDF5 file's datasets: parsed at open (through a read-only mmap),
    read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self.datasets: Dict[str, DatasetInfo] = {}
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        self._superblock()
        self._walk_group(self._root, "")

    def close(self) -> None:
        self._buf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- primitives ---------------------------------------------------------
    def _u(self, pos: int, n: int) -> int:
        return int.from_bytes(self._buf[pos:pos + n], "little")

    def _addr(self, pos: int) -> Optional[int]:
        """An address field: None when undefined (all bits set), else the
        absolute file offset."""
        v = self._u(pos, self.so)
        if v == (1 << (8 * self.so)) - 1:
            return None
        return v + self.base

    def _superblock(self) -> None:
        if self._buf[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: no HDF5 superblock at the start of the file "
                             "(files with a user block are not read here)")
        if self._buf[8] != 0:
            raise ValueError(f"{self.path}: superblock version {self._buf[8]} (only version 0 "
                             "reads here; the file was written with a newer libver)")
        self.so, self.sl = self._buf[13], self._buf[14]
        self.base = self._u(24, self.so)
        # past base, free space, end of file and driver block: the root
        # group's symbol table entry, whose second field is its object header
        self._root = self._addr(24 + 5 * self.so)

    # -- object headers -----------------------------------------------------
    def _messages(self, addr: int, name: str) -> List[Tuple[int, int, int]]:
        """A version-1 object header's messages as (type, flags, data offset)."""
        if self._buf[addr:addr + 4] == b"OHDR":
            raise ValueError(f"{name or '/'}: version-2 object header (not readable here)")
        version = self._buf[addr]
        if version != 1:
            raise ValueError(f"{name or '/'}: object header version {version}")
        n_msgs = self._u(addr + 2, 2)
        blocks = [(addr + 16, self._u(addr + 8, 4))]
        out = []
        while blocks and len(out) < n_msgs:
            start, size = blocks.pop(0)
            p = start
            while p + 8 <= start + size and len(out) < n_msgs:
                mtype, msize, mflags = self._u(p, 2), self._u(p + 2, 2), self._buf[p + 4]
                if mtype == MSG_CONTINUATION:
                    blocks.append((self._addr(p + 8), self._u(p + 8 + self.so, self.sl)))
                out.append((mtype, mflags, p + 8))
                p += 8 + msize
        return out

    def _walk_group(self, addr: int, prefix: str) -> None:
        msgs = self._messages(addr, prefix)
        stab = [m for m in msgs if m[0] == MSG_SYMBOL_TABLE]
        for mtype, _, _ in msgs:
            if mtype in (MSG_LINK, MSG_LINK_INFO, MSG_GROUP_INFO):
                raise ValueError(f"{prefix or '/'}: link message 0x{mtype:04x} (new-style "
                                 "group; only symbol-table groups read here)")
        if not stab:
            raise ValueError(f"{prefix or '/'}: group without a symbol table message")
        p = stab[0][2]
        btree, heap = self._addr(p), self._addr(p + self.so)
        if self._buf[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{prefix or '/'}: no local heap at {heap}")
        heap_data = self._addr(heap + 8 + 2 * self.sl)
        for name_off, obj in self._group_entries(btree, prefix):
            end = self._buf.find(b"\0", heap_data + name_off)
            name = prefix + self._buf[heap_data + name_off:end].decode()
            msgs = self._messages(obj, name)
            if any(m[0] == MSG_SYMBOL_TABLE for m in msgs):
                self._walk_group(obj, name + "/")
            else:
                self.datasets[name] = self._dataset(name, msgs)

    def _group_entries(self, node: int, prefix: str) -> List[Tuple[int, int]]:
        """(name offset in the local heap, object header address) of every
        symbol under a type-0 B-tree node."""
        if self._buf[node:node + 4] != b"TREE" or self._buf[node + 4] != 0:
            raise ValueError(f"{prefix or '/'}: group B-tree node is not a type-0 TREE")
        level, used = self._buf[node + 5], self._u(node + 6, 2)
        p = node + 8 + 2 * self.so + self.sl  # past the header and key 0
        out = []
        for _ in range(used):
            child = self._addr(p)
            p += self.so + self.sl
            if level > 0:
                out += self._group_entries(child, prefix)
                continue
            if self._buf[child:child + 4] != b"SNOD":
                raise ValueError(f"{prefix or '/'}: no symbol node at {child}")
            entry = 2 * self.so + 24
            for i in range(self._u(child + 6, 2)):
                e = child + 8 + i * entry
                out.append((self._u(e, self.so), self._addr(e + self.so)))
        return out

    # -- dataset messages ---------------------------------------------------
    def _dataset(self, name: str, msgs) -> DatasetInfo:
        got = {}
        for mtype, mflags, p in msgs:
            if mtype in (MSG_DATATYPE, MSG_DATASPACE, MSG_LAYOUT) and mflags & 0x2:
                raise ValueError(f"{name}: shared message 0x{mtype:04x}")
            got.setdefault(mtype, p)
        for need in (MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT):
            if need not in got:
                raise ValueError(f"{name}: object header without message 0x{need:04x}")
        shape = self._dataspace(name, got[MSG_DATASPACE])
        dtype, elem_size, vlen = self._datatype(name, got[MSG_DATATYPE])
        filters = self._filters(name, got[MSG_FILTERS]) if MSG_FILTERS in got else []
        fill = self._fill(got.get(MSG_FILL), got.get(MSG_FILL_OLD), elem_size)
        info = DatasetInfo(name, shape, dtype, elem_size, vlen, 1, None, None, filters, fill)
        p = got[MSG_LAYOUT]
        version, cls = self._buf[p], self._buf[p + 1]
        if version != 3:
            raise ValueError(f"{name}: data layout message version {version} (only 3)")
        info.layout = cls
        if cls == 1:
            info.address = self._addr(p + 2)
        elif cls == 2:
            rank1 = self._buf[p + 2]
            info.address = self._addr(p + 3)
            q = p + 3 + self.so
            info.chunks = tuple(self._u(q + 4 * i, 4) for i in range(rank1 - 1))
        else:
            raise ValueError(f"{name}: layout class {cls}")
        return info

    def _dataspace(self, name: str, p: int) -> Tuple[int, ...]:
        version, rank = self._buf[p], self._buf[p + 1]
        if version == 1:
            q = p + 8
        elif version == 2:
            if self._buf[p + 3] == 2:
                raise ValueError(f"{name}: null dataspace")
            q = p + 4
        else:
            raise ValueError(f"{name}: dataspace version {version}")
        return tuple(self._u(q + i * self.sl, self.sl) for i in range(rank))

    def _datatype(self, name: str, p: int) -> Tuple[np.dtype, int, bool]:
        cls = self._buf[p] & 0x0F
        bits = self._u(p + 1, 3)
        size = self._u(p + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0:
            offset, precision = self._u(p + 8, 2), self._u(p + 10, 2)
            if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
                raise ValueError(f"{name}: fixed-point type of {size} bytes, bit offset "
                                 f"{offset}, precision {precision}")
            return np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}"), size, False
        if cls == 1:
            offset, precision = self._u(p + 8, 2), self._u(p + 10, 2)
            if size not in (4, 8) or offset != 0 or precision != 8 * size or bits & 0x40:
                raise ValueError(f"{name}: floating-point type of {size} bytes, bit offset "
                                 f"{offset}, precision {precision}")
            return np.dtype(f"{order}f{size}"), size, False
        if cls == 3:
            return np.dtype(f"S{size}"), size, False
        if cls == 9:
            if bits & 0xF != 1:
                raise ValueError(f"{name}: variable-length sequence (only strings)")
            return np.dtype(object), size, True
        raise ValueError(f"{name}: datatype class {cls}")

    def _filters(self, name: str, p: int) -> List[Tuple[int, Tuple[int, ...]]]:
        version, n = self._buf[p], self._buf[p + 1]
        q = p + (8 if version == 1 else 2)
        out = []
        for _ in range(n):
            fid = self._u(q, 2)
            name_len = 0 if version == 2 and fid < 256 else self._u(q + 2, 2)
            q += 4 if version == 2 and fid < 256 else 6
            n_vals = self._u(q, 2)
            q += 2 + (name_len + 7) // 8 * 8 if version == 1 else 2 + name_len
            vals = tuple(self._u(q + 4 * i, 4) for i in range(n_vals))
            q += 4 * n_vals + (4 if version == 1 and n_vals % 2 else 0)
            if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
                raise ValueError(f"{name}: filter {fid} (only deflate and shuffle)")
            out.append((fid, vals))
        return out

    def _fill(self, p: Optional[int], p_old: Optional[int], elem_size: int) -> Optional[bytes]:
        if p is not None:
            version = self._buf[p]
            if version in (1, 2):
                defined = self._buf[p + 3]
                if version == 2 and not defined:
                    return None
                size, q = self._u(p + 4, 4), p + 8
            elif version == 3:
                flags = self._buf[p + 1]
                if not flags & 0x20:
                    return None
                size, q = self._u(p + 2, 4), p + 6
            else:
                return None
        elif p_old is not None:
            size, q = self._u(p_old, 4), p_old + 4
        else:
            return None
        if size != elem_size:
            return None
        return self._buf[q:q + size]

    # -- data ---------------------------------------------------------------
    def _raw_dtype(self, info: DatasetInfo) -> np.dtype:
        return np.dtype(f"V{info.elem_size}") if info.vlen_str else info.dtype

    def _filled(self, info: DatasetInfo, shape) -> np.ndarray:
        dt = self._raw_dtype(info)
        if info.fill is None:
            return np.zeros(shape, dt)
        return np.full(shape, np.frombuffer(info.fill, dt)[0], dt)

    def _unfilter(self, info: DatasetInfo, data: bytes, mask: int) -> bytes:
        for i in reversed(range(len(info.filters))):
            if mask & (1 << i):
                continue
            fid, vals = info.filters[i]
            if fid == FILTER_DEFLATE:
                data = zlib.decompress(data)
            else:
                size = vals[0] if vals else info.elem_size
                a = np.frombuffer(data, np.uint8)
                n = a.size // size
                body = a[:n * size].reshape(size, n).T.reshape(-1)
                data = body.tobytes() + a[n * size:].tobytes()
        return data

    def _chunk_entries(self, info: DatasetInfo, node: int) -> List[Tuple[int, int, tuple, int]]:
        """(stored bytes, filter mask, element offset, address) of every
        chunk under a type-1 B-tree node."""
        if self._buf[node:node + 4] != b"TREE" or self._buf[node + 4] != 1:
            raise ValueError(f"{info.name}: chunk index is not a type-1 B-tree "
                             "(only version-1 B-tree chunk indexes read here)")
        level, used = self._buf[node + 5], self._u(node + 6, 2)
        rank1 = len(info.chunks) + 1
        key = 8 + 8 * rank1
        p = node + 8 + 2 * self.so
        out = []
        for i in range(used):
            size, mask = self._u(p, 4), self._u(p + 4, 4)
            offs = tuple(self._u(p + 8 + 8 * d, 8) for d in range(rank1 - 1))
            child = self._addr(p + key)
            if level > 0:
                out += self._chunk_entries(info, child)
            else:
                out.append((size, mask, offs, child))
            p += key + self.so
        return out

    def _raw(self, info: DatasetInfo) -> np.ndarray:
        """The stored elements as an array of the stored dtype."""
        dt = self._raw_dtype(info)
        shape = info.shape
        n = int(np.prod(shape, dtype=np.int64))
        if info.layout == 1:
            if info.address is None or n == 0:
                return self._filled(info, shape)
            return np.frombuffer(self._buf, dt, n, info.address).reshape(shape).copy()
        out = self._filled(info, shape)
        if info.address is None or n == 0:
            return out
        for size, mask, offs, addr in self._chunk_entries(info, info.address):
            data = self._buf[addr:addr + size]
            if info.filters:
                data = self._unfilter(info, data, mask)
            chunk = np.frombuffer(data, dt, int(np.prod(info.chunks))).reshape(info.chunks)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offs, info.chunks, shape))
            out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _gheap_object(self, addr: int, index: int) -> bytes:
        if addr not in self._gheaps:
            if self._buf[addr:addr + 4] != b"GCOL":
                raise ValueError(f"no global heap collection at {addr}")
            end = addr + self._u(addr + 8, self.sl)
            objs, p = {}, addr + 8 + self.sl
            while p + 8 + self.sl <= end:
                idx, size = self._u(p, 2), self._u(p + 8, self.sl)
                if idx == 0:
                    break
                objs[idx] = self._buf[p + 8 + self.sl:p + 8 + self.sl + size]
                p += 8 + self.sl + (size + 7) // 8 * 8
            self._gheaps[addr] = objs
        return self._gheaps[addr][index]

    def read(self, name: str) -> np.ndarray:
        """The dataset as a numpy array, in the file's byte order (as h5py
        gives it)."""
        info = self.datasets[name]
        raw = self._raw(info)
        if info.vlen_str:
            b = raw.reshape(-1).view(np.uint8).reshape(-1, info.elem_size)
            out = np.empty(b.shape[0], object)
            for i, row in enumerate(b):
                length = int.from_bytes(row[:4].tobytes(), "little")
                addr = int.from_bytes(row[4:4 + self.so].tobytes(), "little") + self.base
                index = int.from_bytes(row[4 + self.so:8 + self.so].tobytes(), "little")
                out[i] = self._gheap_object(addr, index)[:length] if length else b""
            return out.reshape(info.shape)
        return raw

    def data_offset(self, name: str) -> Optional[int]:
        """File offset of an unfiltered contiguous dataset's elements; None
        for any other storage."""
        info = self.datasets[name]
        if info.layout != 1 or info.filters or info.address is None:
            return None
        return info.address

    def row_offsets(self, name: str) -> Optional[np.ndarray]:
        """File offset of each first-axis row of an unfiltered uint8
        dataset whose rows are each one contiguous byte range; else None."""
        info = self.datasets[name]
        if info.dtype != np.uint8 or len(info.shape) < 1 or info.filters:
            return None
        n, rowbytes = info.shape[0], int(np.prod(info.shape[1:], dtype=np.int64))
        if info.layout == 1:
            if info.address is None:
                return None
            return info.address + np.arange(n, dtype=np.int64) * rowbytes
        if info.layout != 2 or info.chunks != (1, *info.shape[1:]) or info.address is None:
            return None
        offs = np.full(n, -1, np.int64)
        for size, mask, off, addr in self._chunk_entries(info, info.address):
            if mask or size != rowbytes:
                return None
            offs[off[0]] = addr
        return None if (offs < 0).any() else offs


def read_h5(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """-> (every dataset as a numpy array, the file offset of each row of
    every unfiltered uint8 dataset whose rows are contiguous byte ranges)."""
    with H5File(path) as f:
        datasets = {name: f.read(name) for name in f.datasets}
        rows = {name: f.row_offsets(name) for name in f.datasets}
    return datasets, {k: v for k, v in rows.items() if v is not None}


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_O = 8  # size of offsets and lengths in written files
_UNDEF = b"\xff" * _O
_INTERNAL_K = 16  # group B-tree internal node K (h5py's default)


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _datatype_message(dt: np.dtype) -> bytes:
    size = dt.itemsize
    if dt.kind in "iu":
        bits = 0x8 if dt.kind == "i" else 0
        return struct.pack("<B3sIHH", 0x10, bytes([bits, 0, 0]), size, 0, 8 * size)
    if dt.kind == "f":
        if size not in (4, 8):
            raise ValueError(f"write_h5: dtype {dt} (floats of 4 or 8 bytes only)")
        exp_loc, exp_size, mant, bias = {4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}[size]
        return struct.pack("<B3sIHHBBBBI", 0x11, bytes([0x20, 8 * size - 1, 0]), size, 0,
                           8 * size, exp_loc, exp_size, 0, mant, bias)
    if dt.kind == "S":
        return struct.pack("<B3sI", 0x13, bytes([1, 0, 0]), size)
    raise ValueError(f"write_h5: dtype {dt} (integers, floats and byte strings only)")


def _dataset_header(shape: Tuple[int, ...], dt: np.dtype, address: Optional[int],
                    nbytes: int) -> bytes:
    space = struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", d) for d in shape)
    layout = struct.pack("<BB", 3, 1) + (
        _UNDEF if address is None else struct.pack("<Q", address)) + struct.pack("<Q", nbytes)
    msgs = (_message(MSG_DATASPACE, space)
            + _message(MSG_DATATYPE, _datatype_message(dt), flags=1)
            + _message(MSG_FILL, struct.pack("<BBBB", 2, 1, 2, 0), flags=1)
            + _message(MSG_LAYOUT, layout))
    return struct.pack("<BxHII4x", 1, 4, 1, len(msgs)) + msgs


def write_h5(path: str, datasets: Dict[str, np.ndarray]) -> str:
    """Write a version-0 HDF5 file of contiguous root datasets (integers,
    floats, byte strings; any rank, rank 0 a scalar) -> path.

    All names go in one symbol node: the superblock's group leaf node K is
    raised to hold them (a node holds 2 K symbols), the names sorted by
    byte order as the format requires."""
    names = sorted(datasets, key=lambda s: s.encode())
    arrays = {}
    for name in names:
        if not name or "/" in name:
            raise ValueError(f"write_h5: dataset name {name!r} (root datasets only)")
        a = np.asarray(datasets[name])
        dt = a.dtype if a.dtype.kind == "S" else a.dtype.newbyteorder("<")
        _datatype_message(dt)
        arrays[name] = np.array(a, dt, order="C")
    leaf_k = max(4, -(-len(names) // 2))

    heap_data = b"\0" * 8  # offset 0: the empty name
    name_off = {}
    for name in names:
        name_off[name] = len(heap_data)
        heap_data += _pad8(name.encode() + b"\0")

    sb_size = 56 + 2 * _O + 24
    root_ohdr = 16 + 8 + 2 * _O
    btree_size = 8 + 2 * _O + 2 * _INTERNAL_K * _O + (2 * _INTERNAL_K + 1) * _O
    heap_hdr = 8 + 3 * _O
    snod_size = 8 + 2 * leaf_k * (2 * _O + 24)
    root, btree = sb_size, sb_size + root_ohdr
    heap = btree + btree_size
    heap_addr = heap + heap_hdr
    snod = heap_addr + len(heap_data)
    pos = snod + snod_size
    headers, data_addr = {}, {}
    for name in names:
        a = arrays[name]
        hdr_len = len(_dataset_header(a.shape, a.dtype, 0, a.nbytes))
        headers[name] = pos
        pos += hdr_len
        data_addr[name] = pos if a.nbytes else None
        pos += a.nbytes + (-a.nbytes % 8)
    eof = pos

    def entry(name_offset: int, obj: int, cache: int = 0, scratch: bytes = b"") -> bytes:
        return struct.pack("<QQI4x", name_offset, obj, cache) + scratch.ljust(16, b"\0")

    out = bytearray()
    out += SIGNATURE + bytes([0, 0, 0, 0, 0, _O, _O, 0])
    out += struct.pack("<HHI", leaf_k, _INTERNAL_K, 0)
    out += struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", eof) + _UNDEF
    out += entry(0, root, 1, struct.pack("<QQ", btree, heap))
    out += struct.pack("<BxHII4x", 1, 1, 1, 24) + _message(
        MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))
    last = name_off[names[-1]] if names else 0
    node = b"TREE" + bytes([0, 0]) + struct.pack("<H", 1 if names else 0) + _UNDEF + _UNDEF
    node += struct.pack("<QQQ", 0, snod, last) if names else b""
    out += node.ljust(btree_size, b"\0")
    # a free-list head of 1 says the heap has no free block
    out += b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack("<QQ", len(heap_data), 1)
    out += struct.pack("<Q", heap_addr) + heap_data
    sn = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(names))
    sn += b"".join(entry(name_off[n], headers[n]) for n in names)
    out += sn.ljust(snod_size, b"\0")
    assert len(out) == snod + snod_size
    with open(path, "wb") as f:
        f.write(out)
        for name in names:
            a = arrays[name]
            assert f.tell() == headers[name]
            f.write(_dataset_header(a.shape, a.dtype, data_addr[name], a.nbytes))
            if a.nbytes:
                f.write(memoryview(a.reshape(-1)).cast("B"))
                f.write(b"\0" * (-a.nbytes % 8))
        assert f.tell() == eof
    return path
