"""The port's HDF5 layer: Digital RF files read and written with numpy and
the standard library alone.

The port never imports h5py (the card's machine has none). This module is
an h5py-shaped subset, exactly the surface the io modules call, so each of
them reaches it through one import line (``from ... import hdf5 as h5py``):

* ``File(path, "r" | "w" | "a")`` as a context manager, ``name in f``,
  ``f[name]``, ``f.attrs`` and ``f.create_dataset(name, shape=,
  maxshape=, dtype=, chunks=, compression="gzip", compression_opts=)``;
* ``Dataset`` ``.shape``, ``.maxshape``, ``.dtype``, ``.chunks``, the
  filter properties, reads ``ds[a:b]``, ``ds[...]``, ``ds[-1]``,
  ``ds[0, 0]``, row writes ``ds[row:] = rows`` / ``ds[-1] = row`` and
  ``.resize(n, axis=0)``;
* ``ds.id.get_offset()``, ``.get_num_chunks()`` and ``.get_chunk_info(k)``
  (chunk offset, filter mask, byte offset, size), for io.fastread.

Dtypes map as h5py maps them: a float ``{r, i}`` compound reads as native
complex, an integer compound stays structured, an HDF5 bool enum reads as
bool; a complex dtype is written as the ``{r, i}`` compound.

What it reads: everything HDF5 writes with its default ("earliest")
format for a Digital RF capture. Superblock v0/v1 with 8-byte offsets and
lengths; v1 object headers with continuation blocks; symbol-table groups
(B-tree type 0, local heap, symbol nodes); v1 dataspaces incl.
unlimited maximum dims; fixed-point, IEEE float (32 and 64 bit), fixed
and variable-length strings (global heap), enums and compounds
(datatype message v1-v3); v1 attributes; layout v3 (contiguous, and
chunked with a type-1 B-tree of any depth); the deflate and shuffle
filters. Attributes are decoded only when read, so one it cannot decode
(upstream digital_rf's long double ``samples_per_second``) stops only
its own read. Any other structure raises FormatError naming it
("superblock version 3", "object header version 2", "layout version 4
(fixed-array index)", "filter 3 (fletcher32)", "big-endian ..."): it
never returns wrong bytes. A file without the HDF5
signature raises OSError, as h5py does (a writer's file before its first
flush looks like that).

What it writes: superblock v0, v1 object headers, a symbol-table root
group, attributes (int, float, and fixed-length null-padded UTF-8
strings: h5py writes variable-length ones, both read back as the same
text) and chunked, growable datasets, optionally gzip-compressed, with the
dataspace, datatype, fill-value, filter-pipeline and layout messages
HDF5 needs to open them. Chunks are appended to the right of the chunk
B-tree, which grows by new leaves and new roots (HDF5's nodes of 2K
entries, K = 32); an existing chunk is rewritten in place (uncompressed)
or moved (compressed, when it outgrows its space).

Concurrency, as HDF5's own file locking: each File ``os.open``s its own
descriptor and takes ``flock`` ``LOCK_SH | LOCK_NB`` for "r" and
``LOCK_EX | LOCK_NB`` for "w"/"a", so it also excludes h5py processes on
the same file. A writer that meets a lock raises OSError at once; a
reader waits up to LOCK_WAIT_S for a writer's append to end, then raises
OSError. A write lands in this order: chunk bytes, B-tree entries, the
dataspace's new dims, then (the caller's next dataset) the index row, so a
reader that maps rows by byte offset without the lock never sees rows
that are not there.
"""

from __future__ import annotations

import errno
import fcntl
import math
import os
import struct
import time
import zlib
from bisect import bisect_left
from collections import namedtuple
from typing import Dict, List, Optional, Tuple

import numpy as np

from pyspectrogram_tpu_torch.utils.errors import FormatError

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF
#: how long a reader waits for a writer's exclusive lock before OSError
LOCK_WAIT_S = 0.5
#: HDF5's defaults, implied by superblock v0: symbol-node K, group B-tree
#: K, chunk B-tree K (a node holds 2K entries)
LEAF_K, GROUP_K, CHUNK_K = 4, 16, 32
#: HDF5 allocates object headers of at least this many bytes of messages
MIN_HEADER = 256
FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
           5: "nbit", 6: "scaleoffset", 32000: "lzf"}
CHUNK_INDEXES = {1: "single-chunk", 2: "implicit", 3: "fixed-array",
                 4: "extensible-array", 5: "version 2 B-tree"}
TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference",
                10: "array"}
#: (precision, exponent location, exponent size, mantissa size, bias) of
#: the IEEE floats read and written, by size in bytes
IEEE = {4: (32, 23, 8, 23, 127), 8: (64, 52, 11, 52, 1023)}

ChunkInfo = namedtuple("ChunkInfo",
                       "chunk_offset filter_mask byte_offset size")

_U16, _U32, _U64 = struct.Struct("<H"), struct.Struct("<I"), struct.Struct("<Q")


def _u16(b, p):
    return _U16.unpack_from(b, p)[0]


def _u32(b, p):
    return _U32.unpack_from(b, p)[0]


def _u64(b, p):
    return _U64.unpack_from(b, p)[0]


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded(b: bytes) -> bytes:
    return b + bytes(_pad8(len(b)) - len(b))


# ------------------------------------------------------------ datatypes
class _Type:
    """A decoded datatype: the numpy dtype of the stored bytes, the dtype
    h5py hands out for them, and whether they are variable-length string
    references into the global heap."""

    __slots__ = ("storage", "memory", "vlen_str")

    def __init__(self, storage, memory=None, vlen_str=False):
        self.storage = np.dtype(storage)
        self.memory = np.dtype(memory) if memory is not None else self.storage
        self.vlen_str = vlen_str


_VLEN = np.dtype([("len", "<u4"), ("addr", "<u8"), ("idx", "<u4")])


def _little(bits: int, what: str) -> None:
    if bits & 1:
        raise FormatError(f"big-endian {what} datatype")


def _decode_type(b, p) -> Tuple[_Type, int]:
    """Datatype message at ``p`` -> (type, position after it)."""
    cls, ver = b[p] & 0x0F, b[p] >> 4
    bits = b[p + 1] | b[p + 2] << 8 | b[p + 3] << 16
    size = _u32(b, p + 4)
    q = p + 8
    if cls == 0:                                        # fixed-point
        _little(bits, "fixed-point")
        off, prec = struct.unpack_from("<HH", b, q)
        if off or prec != 8 * size or size not in (1, 2, 4, 8):
            raise FormatError(f"fixed-point of {prec} bits at bit {off} "
                              f"in {size} bytes")
        return _Type(f"<{'i' if bits & 8 else 'u'}{size}"), q + 4
    if cls == 1:                                        # floating point
        if bits & 0x41:
            raise FormatError("big-endian floating-point datatype")
        off, prec, eloc, esize, mloc, msize, bias = struct.unpack_from(
            "<HHBBBBI", b, q)
        if IEEE.get(size) == (prec, eloc, esize, msize, bias) and not off:
            return _Type(f"<f{size}"), q + 12
        raise FormatError(f"floating point of {size} bytes with {prec}-bit "
                          f"precision")
    if cls == 3:                                        # fixed string
        return _Type(f"S{size}"), q
    if cls == 6:                                        # compound
        names, formats, offsets = [], [], []
        for _ in range(bits & 0xFFFF):
            e = b.index(b"\0", q)
            names.append(bytes(b[q:e]).decode())
            q = e + 1 if ver >= 3 else q + _pad8(e - q + 1)
            if ver >= 3:
                nb = 1 if size < 1 << 8 else 2 if size < 1 << 16 else \
                    3 if size < 1 << 24 else 4
                offsets.append(int.from_bytes(b[q:q + nb], "little"))
                q += nb
            else:
                offsets.append(_u32(b, q))
                if ver == 1:
                    if b[q + 4]:
                        raise FormatError("compound member that is an array")
                    q += 28
                q += 4
            member, q = _decode_type(b, q)
            if member.vlen_str:
                raise FormatError("compound with a variable-length member")
            formats.append(member.storage)
        storage = np.dtype({"names": names, "formats": formats,
                            "offsets": offsets, "itemsize": size})
        memory = None
        f0 = formats[0] if formats else None
        if (names == ["r", "i"] and f0.kind == "f" and formats[1] == f0
                and f0.itemsize in (4, 8)
                and offsets == [0, f0.itemsize] and size == 2 * f0.itemsize):
            memory = np.dtype(f"<c{size}")
        return _Type(storage, memory), q
    if cls == 8:                                        # enumeration
        base, q = _decode_type(b, q)
        n = bits & 0xFFFF
        names = []
        for _ in range(n):
            e = b.index(b"\0", q)
            names.append(bytes(b[q:e]).decode())
            q = e + 1 if ver >= 3 else q + _pad8(e - q + 1)
        vals = np.frombuffer(bytes(b[q:q + n * base.storage.itemsize]),
                             base.storage).tolist()
        q += n * base.storage.itemsize
        memory = None
        if (names == ["FALSE", "TRUE"] and vals == [0, 1]
                and base.storage.itemsize == 1):
            memory = np.dtype(bool)
        return _Type(base.storage, memory), q
    if cls == 9:                                        # variable length
        if bits & 0xF != 1:
            raise FormatError("variable-length sequence datatype")
        if size != 16:
            raise FormatError(f"variable-length string of {size} bytes")
        _, q = _decode_type(b, q)
        return _Type(_VLEN, vlen_str=True), q
    raise FormatError(f"datatype class {cls} "
                      f"({TYPE_CLASSES.get(cls, 'unknown')})")


def _encode_type(dt: np.dtype) -> bytes:
    """Datatype message (version 1) of a little-endian numpy dtype."""
    dt = np.dtype(dt)
    if dt.kind == "c":
        base = np.dtype(f"<f{dt.itemsize // 2}")
        dt = np.dtype([("r", base), ("i", base)])
    if dt.names is not None:
        body = b""
        for name in dt.names:
            fdt, off = dt.fields[name][:2]
            body += (_padded(name.encode() + b"\0")
                     + struct.pack("<IB3xI4x16x", off, 0, 0)
                     + _encode_type(fdt))
        return struct.pack("<BHBI", 0x16, len(dt.names), 0,
                           dt.itemsize) + body
    if dt.byteorder == ">" or (dt.byteorder == "=" and
                               np.little_endian is False):
        raise FormatError(f"big-endian {dt} is not written")
    if dt.kind in "iu":
        return struct.pack("<B3BIHH", 0x10, 8 if dt.kind == "i" else 0, 0, 0,
                           dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in IEEE:
        prec, eloc, esize, msize, bias = IEEE[dt.itemsize]
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, prec - 1, 0,
                           dt.itemsize, 0, prec, eloc, esize, 0, msize, bias)
    if dt.kind == "S":
        # null-padded, UTF-8
        return struct.pack("<B3BI", 0x13, 0x11, 0, 0, dt.itemsize)
    raise FormatError(f"datatype {dt} is not written")


# ------------------------------------------------------------ dataspace
def _decode_space(b, p):
    """Dataspace message -> (shape, maxshape, position of the dims)."""
    ver, rank, flags = b[p], b[p + 1], b[p + 2]
    if ver != 1:
        raise FormatError(f"dataspace version {ver}")
    q = p + 8
    shape = struct.unpack_from(f"<{rank}Q", b, q)
    maxshape = shape
    if flags & 1:
        maxshape = struct.unpack_from(f"<{rank}Q", b, q + 8 * rank)
    return (tuple(shape),
            tuple(None if m == UNDEF else m for m in maxshape), q - p)


def _encode_space(shape, maxshape=None) -> bytes:
    if not shape:
        return struct.pack("<BBB5x", 1, 0, 0)
    maxshape = shape if maxshape is None else maxshape
    return (struct.pack("<BBB5x", 1, len(shape), 1)
            + struct.pack(f"<{len(shape)}Q", *shape)
            + struct.pack(f"<{len(shape)}Q",
                          *(UNDEF if m is None else m for m in maxshape)))


# ------------------------------------------------------------ h5py guess
def guess_chunk(shape, typesize: int) -> Tuple[int, ...]:
    """Chunk shape h5py picks when a growable dataset names none: unlimited
    (zero-length) axes count as 1024, then axes are halved in turn until
    the chunk is near a size that grows with the dataset (8 KiB - 1 MiB)."""
    chunks = [float(x if x else 1024) for x in shape]
    target = 16 * 1024 * 2 ** math.log10(
        math.prod(chunks) * typesize / (1024.0 * 1024))
    target = min(max(target, 8 * 1024), 1024 * 1024)
    i = 0
    while True:
        nbytes = math.prod(chunks) * typesize
        if ((nbytes < target or abs(nbytes - target) / target < 0.5)
                and nbytes < 1024 * 1024) or math.prod(chunks) == 1:
            break
        chunks[i % len(chunks)] = math.ceil(chunks[i % len(chunks)] / 2.0)
        i += 1
    return tuple(int(x) for x in chunks)


# ------------------------------------------------------------ headers
class _Msg:
    __slots__ = ("type", "flags", "addr", "size")

    def __init__(self, mtype, flags, addr, size):
        self.type, self.flags, self.addr, self.size = mtype, flags, addr, size


class _Header:
    """A v1 object header: its messages across its continuation blocks
    (``addr`` is the address of a message's data)."""

    def __init__(self, f: "File", addr: int):
        self.addr = addr
        head = f._read(addr, 512)
        if len(head) < 16:
            raise OSError(errno.EIO, f"truncated object header at {addr}")
        if head[:4] == b"OHDR":
            raise FormatError("object header version 2")
        if head[0] != 1:
            raise FormatError(f"object header version {head[0]}")
        self.nmsgs = _u16(head, 2)
        size = _u32(head, 8)
        first = head[16:16 + size]
        if len(first) < size:
            first = f._read(addr + 16, size)
        self.msgs: List[_Msg] = []
        self.data: Dict[int, bytes] = {}
        todo = [(addr + 16, first)]
        while todo:
            base, blk = todo.pop(0)
            p = 0
            while p + 8 <= len(blk):
                mtype, msize, flags = struct.unpack_from("<HHB", blk, p)
                m = _Msg(mtype, flags, base + p + 8, msize)
                self.msgs.append(m)
                self.data[m.addr] = bytes(blk[p + 8:p + 8 + msize])
                if mtype == 0x10:
                    caddr, clen = struct.unpack_from("<QQ", blk, p + 8)
                    todo.append((caddr, f._read(caddr, clen)))
                p += 8 + msize

    def find(self, mtype: int) -> Optional[_Msg]:
        for m in self.msgs:
            if m.type == mtype:
                if m.flags & 2:
                    raise FormatError(f"shared message of type {mtype:#x}")
                return m
        return None


def _attr_name(data: bytes) -> str:
    if data[0] != 1:
        raise FormatError(f"attribute message version {data[0]}")
    return data[8:8 + _u16(data, 2)].rstrip(b"\0").decode()


class AttributeManager:
    """``obj.attrs``: read when indexed, written as v1 attribute messages."""

    def __init__(self, f: "File", header: _Header):
        self._f, self._h = f, header

    def _messages(self) -> Dict[str, _Msg]:
        return {_attr_name(self._h.data[m.addr]): m for m in self._h.msgs
                if m.type == 0x0C}

    def __iter__(self):
        return iter(self._messages())

    def __contains__(self, name) -> bool:
        return name in self._messages()

    def __getitem__(self, name):
        m = self._messages().get(name)
        if m is None:
            raise KeyError(f"no attribute {name!r}")
        b = self._h.data[m.addr]
        nsize, tsize, ssize = struct.unpack_from("<HHH", b, 2)
        p = 8 + _pad8(nsize)
        t, _ = _decode_type(b, p)
        p += _pad8(tsize)
        shape, _, _ = _decode_space(b, p)
        p += _pad8(ssize)
        n = math.prod(shape)
        raw = np.frombuffer(b, t.storage, count=n, offset=p).reshape(shape)
        if t.vlen_str:
            out = np.array([self._f._vlen_str(r) for r in raw.reshape(-1)],
                           object).reshape(shape)
            return out[()] if not shape else out
        out = raw.view(t.memory) if t.memory != t.storage else raw.copy()
        return out[()] if not shape else out

    def __setitem__(self, name, value):
        self._f._writable()
        if isinstance(value, str):
            arr = np.array(value.encode())
        elif isinstance(value, bool):
            raise TypeError("bool attributes are not written")
        elif isinstance(value, int):
            arr = np.array(value, np.int64)
        elif isinstance(value, float):
            arr = np.array(value, np.float64)
        else:
            arr = np.asarray(value)
        if arr.dtype.kind == "S" and arr.dtype.itemsize == 0:
            arr = arr.astype("S1")
        name_b = name.encode() + b"\0"
        t = _encode_type(arr.dtype)
        s = _encode_space(arr.shape)
        body = (struct.pack("<BBHHH", 1, 0, len(name_b), len(t), len(s))
                + _padded(name_b) + _padded(t) + _padded(s)
                + np.ascontiguousarray(arr).tobytes())
        old = self._messages().get(name)
        if old is not None:
            self._f._nil(self._h, old)
        self._f._add_message(self._h, 0x0C, body)


# ------------------------------------------------------------ B-tree
class _Node:
    """A chunk B-tree (type 1) node in memory. ``keys`` holds the key left
    of each child; the key right of the last child is derived on write."""

    __slots__ = ("addr", "level", "keys", "children", "kids", "image")

    def __init__(self, addr, level, keys, children, kids=None, image=b""):
        self.addr, self.level = addr, level
        self.keys, self.children = keys, children
        self.kids = kids
        self.image = image


class _ChunkTree:
    """A dataset's chunk index (v1 B-tree of type 1), read whole: its
    leaves in order, and the right-end appends and in-place updates a
    writer makes."""

    def __init__(self, ds: "Dataset"):
        self.ds = ds
        f = ds._f
        self.ndims = len(ds.chunks) + 1
        self.key_size = 8 + 8 * self.ndims
        self.dims = ds.chunks + (ds._elem_size,)
        self.levels: List[List[_Node]] = []
        self.root: Optional[_Node] = None
        if ds._btree != UNDEF:
            self.root = self._load(f, ds._btree)
            lv = [self.root]
            while lv:
                self.levels.insert(0, lv)
                lv = [k for n in lv for k in (n.kids or ())]
        self._index()
        self.root_moved = False

    def _load(self, f, addr) -> _Node:
        head = f._read(addr, 24)
        if head[:4] != b"TREE":
            raise FormatError(f"chunk B-tree node signature at {addr}")
        if head[4] != 1:
            raise FormatError(f"B-tree node type {head[4]} in a chunk index")
        level, n = head[5], _u16(head, 6)
        ks = self.key_size
        size = 24 + n * (ks + 8) + ks
        b = f._read(addr, size)
        keys, children = [], []
        p = 24
        for _ in range(n):
            keys.append(self._key(b, p))
            children.append(_u64(b, p + ks))
            p += ks + 8
        image = bytes(b) + bytes(max(self.node_bytes() - len(b), 0))
        node = _Node(addr, level, keys, children, image=image)
        if level:
            node.kids = [self._load(f, c) for c in children]
        return node

    def _key(self, b, p):
        return (_u32(b, p), _u32(b, p + 4),
                struct.unpack_from(f"<{self.ndims}Q", b, p + 8))

    def _index(self):
        self.entries = [(k, c) for leaf in (self.levels[0] if self.levels
                                            else ())
                        for k, c in zip(leaf.keys, leaf.children)]
        self.firsts = [k[2] for k, _ in self.entries]

    # ---- writes
    def node_bytes(self) -> int:
        k2 = 2 * self.ds._f._chunk_k
        return 24 + (k2 + 1) * self.key_size + k2 * 8

    def set_chunk(self, offs, addr, nbytes):
        """Point the chunk at ``offs`` (element offsets, rank long) to
        ``addr``: in place if the tree holds it, else appended at the
        right end (it must lie right of every chunk there)."""
        key = (nbytes, 0, tuple(offs) + (0,))
        i = bisect_left(self.firsts, key[2])
        if i < len(self.firsts) and self.firsts[i] == key[2]:
            for leaf in self.levels[0]:
                for j, k in enumerate(leaf.keys):
                    if k[2] == key[2]:
                        leaf.keys[j], leaf.children[j] = key, addr
            self._index()
            return
        if i != len(self.firsts):
            raise FormatError("chunk insert left of the chunk B-tree's end")
        self.entries.append((key, addr))
        self.firsts.append(key[2])
        f = self.ds._f
        if self.root is None:
            self.root = _Node(f._alloc(self.node_bytes()), 0, [], [])
            self.levels = [[self.root]]
            self.root_moved = True
        leaf = self.levels[0][-1]
        if len(leaf.children) < 2 * f._chunk_k:
            leaf.keys.append(key)
            leaf.children.append(addr)
        else:
            self._attach(_Node(f._alloc(self.node_bytes()), 0, [key], [addr]))

    def _attach(self, node: _Node):
        """Add ``node`` as the new right-most node of its level, making
        room above it (a new parent, or a new root) as needed."""
        lv = node.level
        self.levels[lv].append(node)
        f = self.ds._f
        if lv + 1 == len(self.levels):
            old = self.root
            self.root = _Node(f._alloc(self.node_bytes()), lv + 1,
                              [None, None], [old.addr, node.addr], [old, node])
            self.levels.append([self.root])
            self.root_moved = True
            return
        parent = self.levels[lv + 1][-1]
        if len(parent.kids) < 2 * f._chunk_k:
            parent.kids.append(node)
            parent.keys.append(None)
            parent.children.append(node.addr)
        else:
            self._attach(_Node(f._alloc(self.node_bytes()), lv + 1, [None],
                               [node.addr], [node]))

    def flush(self) -> None:
        """Write every node whose bytes changed, leaves first, with the
        keys HDF5 keeps: a node's key i is its child i's first key, and
        its right key the next node's first key, or (at the right end)
        the last chunk's offset plus one chunk in every dimension."""
        if self.root is None:
            return
        f = self.ds._f
        for nodes in self.levels:
            for j, n in enumerate(nodes):
                if n.level:
                    n.keys = [k.keys[0] for k in n.kids]
                if j + 1 < len(nodes):
                    right = self._first(nodes[j + 1])
                else:
                    last = self._last(n)
                    right = (0, 0, tuple((o // d + 1) * d
                                         for o, d in zip(last[2], self.dims)))
                left = nodes[j - 1].addr if j else UNDEF
                rsib = nodes[j + 1].addr if j + 1 < len(nodes) else UNDEF
                parts = [b"TREE", struct.pack("<BBHQQ", 1, n.level,
                                              len(n.children), left, rsib)]
                for k, c in zip(n.keys, n.children):
                    parts.append(self._pack_key(k))
                    parts.append(_U64.pack(c))
                parts.append(self._pack_key(right))
                image = b"".join(parts)
                image += bytes(self.node_bytes() - len(image))
                if image != n.image:
                    f._write(n.addr, image)
                    n.image = image
        if self.root_moved:
            f._write(self.ds._layout_addr_pos, _U64.pack(self.root.addr))
            self.ds._btree = self.root.addr
            self.root_moved = False

    def _first(self, n):
        while n.level:
            n = n.kids[0]
        return n.keys[0]

    def _last(self, n):
        while n.level:
            n = n.kids[-1]
        return n.keys[-1]

    def _pack_key(self, k) -> bytes:
        return struct.pack(f"<II{self.ndims}Q", k[0], k[1], *k[2])


# ------------------------------------------------------------ dataset
class _DatasetID:
    """``ds.id``: the storage queries io.fastread makes."""

    def __init__(self, ds: "Dataset"):
        self._ds = ds

    def get_offset(self) -> Optional[int]:
        ds = self._ds
        if ds._layout != "contiguous" or ds._addr == UNDEF:
            return None
        return ds._addr

    def get_num_chunks(self) -> int:
        return len(self._ds._tree().entries) if self._ds.chunks else 0

    def get_chunk_info(self, k: int) -> ChunkInfo:
        key, addr = self._ds._tree().entries[k]
        rank = len(self._ds.shape)
        return ChunkInfo(tuple(key[2][:rank]), key[1], addr, key[0])


class Dataset:
    """One dataset of a File, parsed when opened; chunks read on demand."""

    def __init__(self, f: "File", name: str, addr: int):
        self._f, self.name = f, name
        h = self._h = _Header(f, addr)
        m = h.find(0x01)
        t = h.find(0x03)
        lay = h.find(0x08)
        if m is None or t is None or lay is None:
            raise FormatError(f"dataset {name!r} without dataspace, datatype "
                              f"or layout message")
        self.shape, self.maxshape, dpos = _decode_space(h.data[m.addr], 0)
        self._dims_pos = m.addr + dpos
        self._dims_dirty = False
        if not self.shape:
            raise FormatError(f"scalar dataset {name!r}")
        self._type, _ = _decode_type(h.data[t.addr], 0)
        if self._type.vlen_str:
            raise FormatError(f"dataset {name!r} of variable-length strings")
        self.dtype = self._type.memory
        self._fill = bytes(self._type.storage.itemsize)
        fm = h.find(0x05)
        if fm is not None:
            self._fill = self._fill_value(h.data[fm.addr]) or self._fill
        self._filters: List[Tuple[int, Tuple[int, ...]]] = []
        pm = h.find(0x0B)
        if pm is not None:
            self._filters = self._pipeline(h.data[pm.addr])
        self._parse_layout(h.data[lay.addr], lay.addr)
        self._chunk_tree: Optional[_ChunkTree] = None
        self.id = _DatasetID(self)

    # ---- messages
    def _fill_value(self, b) -> Optional[bytes]:
        """The fill value's bytes (version 1/2 message), None for the
        default (zeros)."""
        if b[0] not in (1, 2):
            raise FormatError(f"fill value message version {b[0]}")
        if b[0] == 2 and not b[3]:
            return None
        size = _u32(b, 4)
        return bytes(b[8:8 + size]) if size else None

    def _pipeline(self, b):
        """[(filter id, client values)] of a version 1 pipeline message."""
        if b[0] != 1:
            raise FormatError(f"filter pipeline version {b[0]}")
        p, out = 8, []
        for _ in range(b[1]):
            fid, nlen, _flags, nvals = struct.unpack_from("<HHHH", b, p)
            p += 8 + _pad8(nlen)
            out.append((fid, struct.unpack_from(f"<{nvals}I", b, p)))
            p += 4 * (nvals + nvals % 2)
        return out

    def _parse_layout(self, b, addr):
        """Layout message version 3: contiguous or chunked (B-tree)."""
        if b[0] != 3:
            if b[0] == 4 and b[1] == 2:
                kind = CHUNK_INDEXES.get(b[5 + b[3] * b[4]], "unknown")
                raise FormatError(f"layout version 4 ({kind} index)")
            raise FormatError(f"layout version {b[0]}")
        self.chunks = None
        self._btree = UNDEF
        if b[1] == 1:
            self._layout = "contiguous"
            self._addr = _u64(b, 2)
        elif b[1] == 2:
            self._layout = "chunked"
            self._btree = _u64(b, 3)
            self._layout_addr_pos = addr + 3
            dims = struct.unpack_from(f"<{b[2]}I", b, 11)
            self.chunks = tuple(int(d) for d in dims[:-1])
            self._elem_size = int(dims[-1])
            if len(self.chunks) != len(self.shape):
                raise FormatError(f"chunk rank {len(self.chunks)} of a rank "
                                  f"{len(self.shape)} dataset")
        else:
            raise FormatError(f"layout class {b[1]} "
                              f"({'compact' if b[1] == 0 else 'unknown'})")

    # ---- h5py's filter properties
    def _filter_ids(self):
        return [fid for fid, _ in self._filters]

    @property
    def compression(self) -> Optional[str]:
        for fid in self._filter_ids():
            if fid == 1:
                return "gzip"
            if fid in (4, 32000):
                return FILTERS[fid]
        return None

    @property
    def compression_opts(self):
        for fid, vals in self._filters:
            if fid == 1:
                return vals[0] if vals else None
        return None

    @property
    def shuffle(self) -> bool:
        return 2 in self._filter_ids()

    @property
    def fletcher32(self) -> bool:
        return 3 in self._filter_ids()

    @property
    def scaleoffset(self):
        for fid, vals in self._filters:
            if fid == 6:
                return vals[1] if len(vals) > 1 else 0
        return None

    # ---- reads
    def _tree(self) -> _ChunkTree:
        if self._chunk_tree is None:
            self._chunk_tree = _ChunkTree(self)
        return self._chunk_tree

    @staticmethod
    def _chunk(tree: _ChunkTree, row: int):
        """(key, address) of the full-width chunk starting at ``row``."""
        offs = (row,) + (0,) * (tree.ndims - 1)
        i = bisect_left(tree.firsts, offs)
        if i < len(tree.firsts) and tree.firsts[i] == offs:
            return tree.entries[i]
        return None

    def _decode_chunk(self, raw: bytes, mask: int) -> bytes:
        for i in range(len(self._filters) - 1, -1, -1):
            if mask & (1 << i):
                continue
            fid, vals = self._filters[i]
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                size = vals[0] if vals else self._type.storage.itemsize
                n = len(raw) // size
                body = np.frombuffer(raw, np.uint8, n * size)
                raw = body.reshape(size, n).T.tobytes() + raw[n * size:]
            else:
                raise FormatError(f"filter {fid} "
                                  f"({FILTERS.get(fid, 'unknown')})")
        return raw

    def _encode_chunk(self, raw: bytes) -> bytes:
        """A chunk through the pipeline on write: deflate only."""
        for fid, vals in self._filters:
            if fid != 1:
                raise FormatError(f"write through filter {fid} "
                                  f"({FILTERS.get(fid, 'unknown')})")
            raw = zlib.compress(raw, vals[0] if vals else 6)
        return raw

    def _empty(self, n: int) -> np.ndarray:
        shape = (n,) + self.shape[1:]
        st = self._type.storage
        if not any(self._fill):
            return np.zeros(shape, st)
        out = np.empty(shape, st)
        out[...] = np.frombuffer(self._fill, st, 1)[0]
        return out

    def _rows(self, a: int, b: int) -> np.ndarray:
        """Rows [a, b) in the stored dtype."""
        n = max(b - a, 0)
        st = self._type.storage
        row = st.itemsize * math.prod(self.shape[1:])
        if n == 0:
            return self._empty(0)
        if self._layout == "contiguous":
            if self._addr == UNDEF:
                return self._empty(n)
            raw = self._f._read(self._addr + a * row, n * row)
            if len(raw) != n * row:
                raise OSError(errno.EIO, f"short read of {self.name!r}")
            return np.frombuffer(raw, st).reshape((n,) + self.shape[1:]).copy()
        out = self._empty(n)
        tree = self._tree()
        cdims = self.chunks
        whole_rows = cdims[1:] == self.shape[1:]
        unfiltered = (1 << len(self._filters)) - 1
        lo = bisect_left(tree.firsts, (max(a - cdims[0] + 1, 0),))
        for key, addr in tree.entries[lo:]:
            offs = key[2][:len(cdims)]
            if offs[0] >= b:
                break
            r0, r1 = max(a, offs[0]), min(b, offs[0] + cdims[0])
            if whole_rows and (key[1] & unfiltered) == unfiltered:
                # an unfiltered chunk of whole rows: read just the rows
                raw = self._f._read(addr + (r0 - offs[0]) * row,
                                    (r1 - r0) * row)
                if len(raw) != (r1 - r0) * row:
                    raise OSError(errno.EIO,
                                  f"short chunk read of {self.name!r}")
                out[r0 - a:r1 - a] = np.frombuffer(raw, st).reshape(
                    (r1 - r0,) + self.shape[1:])
                continue
            raw = self._f._read(addr, key[0])
            if len(raw) != key[0]:
                raise OSError(errno.EIO, f"short chunk read of {self.name!r}")
            raw = self._decode_chunk(raw, key[1])
            if len(raw) != math.prod(cdims) * st.itemsize:
                raise FormatError(f"chunk of {len(raw)} bytes in "
                                  f"{self.name!r}")
            chunk = np.frombuffer(raw, st).reshape(cdims)
            src = [slice(r0 - offs[0], r1 - offs[0])]
            dst = [slice(r0 - a, r1 - a)]
            for o, c, s in zip(offs[1:], cdims[1:], self.shape[1:]):
                if o >= s:
                    break
                src.append(slice(0, min(c, s - o)))
                dst.append(slice(o, min(o + c, s)))
            else:
                out[tuple(dst)] = chunk[tuple(src)]
        return out

    def _to_memory(self, arr: np.ndarray) -> np.ndarray:
        if self._type.memory != self._type.storage:
            return arr.view(self._type.memory)
        return arr

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        first, rest = (key[0], key[1:]) if key else (Ellipsis, ())
        if first is Ellipsis:
            first = slice(None)
        n = self.shape[0]
        if isinstance(first, slice):
            a, b, step = first.indices(n)
            if step != 1:
                raise TypeError("row slices take no step")
            block = self._to_memory(self._rows(a, max(a, b)))
            return block[(slice(None),) + rest] if rest else block
        i = int(first)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"row {first} out of range for {n} rows")
        row = self._to_memory(self._rows(i, i + 1))[0]
        return row[rest] if rest else row

    # ---- writes
    def resize(self, size, axis: int = 0) -> None:
        self._f._writable()
        if axis != 0:
            raise TypeError("only the first axis grows")
        size = int(size)
        mx = self.maxshape[0]
        if self.chunks is None or (mx is not None and size > mx):
            raise ValueError(f"cannot resize {self.name!r} to {size} rows")
        self.shape = (size,) + self.shape[1:]
        self._dims_dirty = True

    def __setitem__(self, key, value):
        self._f._writable()
        if not isinstance(key, tuple):
            key = (key,)
        n = self.shape[0] if self.shape else 0
        first = key[0] if key else slice(None)
        if len(key) > 1 and any(k != slice(None) for k in key[1:]):
            raise TypeError("writes take whole rows")
        if isinstance(first, slice):
            a, b, step = first.indices(n)
            if step != 1:
                raise TypeError("row slices take no step")
        else:
            a = int(first) + (n if int(first) < 0 else 0)
            if not 0 <= a < n:
                raise IndexError(f"row {first} out of range for {n} rows")
            b = a + 1
        st = self._type.storage
        arr = np.asarray(value)
        if arr.dtype == self._type.memory and self._type.memory != st:
            arr = np.ascontiguousarray(arr).view(st)
        elif arr.dtype != st:
            arr = arr.astype(st)
        arr = np.broadcast_to(arr, (b - a,) + self.shape[1:])
        self._write_rows(a, np.ascontiguousarray(arr))
        self._flush_dims()
        self._f._flush_eof()

    def _write_rows(self, a: int, rows: np.ndarray) -> None:
        if self.chunks is None:
            raise FormatError(f"write to the {self._layout} dataset "
                              f"{self.name!r}")
        if self.chunks[1:] != self.shape[1:]:
            raise FormatError(f"write to {self.name!r}, whose chunks split "
                              f"its rows")
        f, tree = self._f, self._tree()
        cr = self.chunks[0]
        st = self._type.storage
        row = rows.itemsize * math.prod(self.shape[1:])
        chunk_bytes = cr * row
        b = a + len(rows)
        plain = not self._filters
        pieces: List[Tuple[int, bytes]] = []
        tail = (0,) * len(self.shape)
        chunk_ids = range(a // cr, -(-b // cr))
        if plain:
            # new chunks side by side, so their rows land in one write
            new = [ci for ci in chunk_ids if self._chunk(tree, ci * cr) is None]
            base = f._alloc(chunk_bytes * len(new)) if new else 0
            for j, ci in enumerate(new):
                tree.set_chunk((ci * cr,) + tail[1:], base + j * chunk_bytes,
                               chunk_bytes)
        for ci in chunk_ids:
            c0 = ci * cr
            r0, r1 = max(a, c0), min(b, c0 + cr)
            data = rows[r0 - a:r1 - a]
            offs = (c0,) + tail[1:]
            have = self._chunk(tree, c0)
            if plain:
                pieces.append((have[1] + (r0 - c0) * row, data.tobytes()))
                continue
            if have is None:
                img = self._empty(cr)
            else:
                raw = self._decode_chunk(f._read(have[1], have[0][0]),
                                         have[0][1])
                img = np.frombuffer(raw, st).reshape(self.chunks).copy()
            img[r0 - c0:r1 - c0] = data
            enc = self._encode_chunk(img.tobytes())
            if have is not None and len(enc) <= have[0][0]:
                addr = have[1]
            else:
                addr = f._alloc(len(enc))
            pieces.append((addr, enc))
            tree.set_chunk(offs, addr, len(enc))
        # chunk bytes first (adjacent pieces in one write), then the tree
        pieces.sort(key=lambda piece: piece[0])
        i = 0
        while i < len(pieces):
            addr, buf = pieces[i]
            parts = [buf]
            end = addr + len(buf)
            i += 1
            while i < len(pieces) and pieces[i][0] == end:
                parts.append(pieces[i][1])
                end += len(pieces[i][1])
                i += 1
            f._write(addr, b"".join(parts) if len(parts) > 1 else parts[0])
        f._extend()
        tree.flush()

    def _flush_dims(self) -> None:
        if self._dims_dirty:
            self._f._write(self._dims_pos,
                           struct.pack(f"<{len(self.shape)}Q", *self.shape))
            self._dims_dirty = False


# ------------------------------------------------------------ file
class File:
    """An HDF5 file opened "r" (shared lock), "w" (created or truncated)
    or "a" (read/write, created if missing), under an exclusive lock."""

    def __init__(self, name, mode: str = "r"):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode {mode!r} (r, w or a)")
        self.filename = os.fspath(name)
        self.mode = mode
        flags = os.O_RDONLY if mode == "r" else os.O_RDWR | os.O_CREAT
        self._fd = os.open(self.filename, flags, 0o666)
        self._datasets: Dict[str, Dataset] = {}
        self._gcols: Dict[int, Dict[int, bytes]] = {}
        self._members: Optional[Dict[str, int]] = None
        self._root: Optional[_Header] = None
        try:
            self._lock()
            if mode == "w":
                os.ftruncate(self._fd, 0)
            self._size = os.fstat(self._fd).st_size
            if self._size == 0 and mode != "r":
                self._create()
            else:
                self._open_superblock()
        except BaseException:
            os.close(self._fd)
            self._fd = -1
            raise

    # ---- lock and raw I/O
    def _lock(self) -> None:
        op = fcntl.LOCK_SH if self.mode == "r" else fcntl.LOCK_EX
        deadline = time.monotonic() + (LOCK_WAIT_S if self.mode == "r" else 0)
        while True:
            try:
                fcntl.flock(self._fd, op | fcntl.LOCK_NB)
                return
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    raise OSError(errno.EAGAIN, "unable to lock file",
                                  self.filename) from None
                time.sleep(0.001)

    def _read(self, addr: int, n: int) -> bytes:
        return os.pread(self._fd, n, addr)

    def _write(self, addr: int, data: bytes) -> None:
        mv = memoryview(data)
        pos = addr
        while mv:
            done = os.pwrite(self._fd, mv, pos)
            mv, pos = mv[done:], pos + done
        self._size = max(self._size, addr + len(data))

    def _alloc(self, n: int) -> int:
        addr = self._eof
        self._eof += n
        return addr

    def _extend(self) -> None:
        """Make the file as long as its allocations (unwritten chunk tails
        read as zeros, the default fill)."""
        if self._size < self._eof:
            os.ftruncate(self._fd, self._eof)
            self._size = self._eof

    def _flush_eof(self) -> None:
        self._extend()
        if self._eof != self._stored_eof:
            self._write(self._eof_pos, _U64.pack(self._eof))
            self._stored_eof = self._eof

    def _writable(self) -> None:
        if self.mode == "r":
            raise ValueError(f"{self.filename} is open read-only")

    # ---- superblock
    def _open_superblock(self) -> None:
        head = os.pread(self._fd, 128, 0)
        if head[:8] != SIGNATURE:
            raise OSError(errno.EINVAL, "not an HDF5 file (no signature at "
                          "its start)", self.filename)
        ver = head[8]
        if ver not in (0, 1):
            raise FormatError(f"superblock version {ver}")
        if head[13] != 8 or head[14] != 8:
            raise FormatError(f"superblock with {head[13]}-byte offsets and "
                              f"{head[14]}-byte lengths")
        self._leaf_k, self._group_k = _u16(head, 16), _u16(head, 18)
        p = 24
        self._chunk_k = CHUNK_K
        if ver == 1:
            self._chunk_k = _u16(head, 24)
            p = 28
        if _u64(head, p):
            raise FormatError(f"base address {_u64(head, p)} (a user block)")
        self._eof_pos = p + 16
        self._stored_eof = self._eof = _u64(head, p + 16)
        self._root_addr = _u64(head, p + 32 + 8)
        self._eof = max(self._eof, self._size)

    def _create(self) -> None:
        """A new file: superblock v0, a root group with an empty B-tree
        and local heap, and room in the root header for attributes."""
        self._leaf_k, self._group_k, self._chunk_k = LEAF_K, GROUP_K, CHUNK_K
        self._eof_pos = 40
        self._stored_eof = 0
        self._root_addr = 96
        hdr_size = MIN_HEADER
        self._eof = 96 + 16 + hdr_size
        bt = self._alloc(self._group_node_bytes())
        heap = self._alloc(32)
        heap_data = self._alloc(88)
        sb = (SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                      LEAF_K, GROUP_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, self._eof, UNDEF)
              + struct.pack("<QQII", 0, self._root_addr, 1, 0)
              + struct.pack("<QQ", bt, heap))
        msgs = (struct.pack("<HHB3x", 0x11, 16, 0) + struct.pack("<QQ", bt, heap)
                + struct.pack("<HHB3x", 0, hdr_size - 32, 0)
                + bytes(hdr_size - 32))
        oh = struct.pack("<BBHII4x", 1, 0, 2, 1, hdr_size) + msgs
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 0, UNDEF, UNDEF)
        node += bytes(self._group_node_bytes() - len(node))
        hp = b"HEAP" + struct.pack("<B3xQQQ", 0, 88, 8, heap_data)
        hd = bytes(8) + struct.pack("<QQ", 1, 80) + bytes(64)
        self._write(0, sb + oh + node + hp + hd)
        self._stored_eof = self._eof

    def _group_node_bytes(self) -> int:
        return 24 + (2 * self._group_k + 1) * 8 + 2 * self._group_k * 8

    # ---- root group
    def _root_header(self) -> _Header:
        if self._root is None:
            self._root = _Header(self, self._root_addr)
        return self._root

    def _group(self):
        """(members {name: header address}, symbol-table message data)."""
        h = self._root_header()
        st = h.find(0x11)
        if st is None:
            if h.find(0x06) is not None or h.find(0x02) is not None:
                raise FormatError("group of link messages (new-style group)")
            raise FormatError("root group without a symbol table")
        return h.data[st.addr]

    def _heap(self, heap_addr: int):
        h = self._read(heap_addr, 32)
        if h[:4] != b"HEAP" or h[4] != 0:
            raise FormatError(f"local heap at {heap_addr}")
        size, free, data_addr = struct.unpack_from("<QQQ", h, 8)
        return size, free, data_addr, self._read(data_addr, size)

    def _group_nodes(self, addr: int, out: list) -> None:
        """Symbol nodes under the group B-tree node at ``addr``, in order."""
        b = self._read(addr, 24)
        if b[:4] != b"TREE" or b[4] != 0:
            raise FormatError(f"group B-tree node at {addr}")
        level, n = b[5], _u16(b, 6)
        b = self._read(addr, 24 + n * 16 + 8)
        for i in range(n):
            child = _u64(b, 24 + 16 * i + 8)
            if level:
                self._group_nodes(child, out)
            else:
                out.append(child)

    def _symbols(self, snod: int):
        b = self._read(snod, 8)
        if b[:4] != b"SNOD":
            raise FormatError(f"symbol table node at {snod}")
        n = _u16(b, 6)
        b = self._read(snod + 8, 40 * n)
        return [struct.unpack_from("<QQ", b, 40 * i) for i in range(n)]

    def _load_members(self) -> Dict[str, int]:
        if self._members is None:
            bt, heap = struct.unpack_from("<QQ", self._group(), 0)
            _, _, _, hdata = self._heap(heap)
            nodes: List[int] = []
            self._group_nodes(bt, nodes)
            members = {}
            for snod in nodes:
                for off, addr in self._symbols(snod):
                    members[hdata[off:hdata.index(b"\0", off)].decode()] = addr
            self._members = members
        return self._members

    def _vlen_str(self, ref) -> str:
        n, addr, idx = int(ref["len"]), int(ref["addr"]), int(ref["idx"])
        objs = self._gcols.get(addr)
        if objs is None:
            h = self._read(addr, 16)
            if h[:4] != b"GCOL" or h[4] != 1:
                raise FormatError(f"global heap collection at {addr}")
            b = self._read(addr, _u64(h, 8))
            objs, p = {}, 16
            while p + 16 <= len(b):
                i, size = _u16(b, p), _u64(b, p + 8)
                if i == 0:
                    break
                objs[i] = bytes(b[p + 16:p + 16 + size])
                p += 16 + _pad8(size)
            self._gcols[addr] = objs
        if idx not in objs:
            raise FormatError(f"global heap object {idx} at {addr}")
        return objs[idx][:n].decode("utf-8")

    # ---- h5py's surface
    @property
    def attrs(self) -> AttributeManager:
        return AttributeManager(self, self._root_header())

    def __contains__(self, name) -> bool:
        return name.strip("/") in self._load_members()

    def __getitem__(self, name) -> Dataset:
        name = name.strip("/")
        ds = self._datasets.get(name)
        if ds is None:
            addr = self._load_members().get(name)
            if addr is None:
                raise KeyError(f"no object {name!r} in {self.filename}")
            ds = self._datasets[name] = Dataset(self, name, addr)
        return ds

    def create_dataset(self, name, shape=None, maxshape=None, dtype=None,
                       chunks=None, compression=None, compression_opts=None):
        """A chunked dataset (h5py's chunk guess when ``chunks`` is None),
        optionally gzip-compressed, linked into the root group."""
        self._writable()
        name = name.strip("/")
        if "/" in name or name in self:
            raise ValueError(f"cannot create {name!r}")
        shape = tuple(int(s) for s in shape)
        maxshape = shape if maxshape is None else tuple(maxshape)
        dt = np.dtype(dtype if dtype is not None else "<f4")
        stored = _encode_type(dt)
        itemsize = dt.itemsize
        if compression not in (None, "gzip"):
            raise ValueError(f"compression {compression!r} is not written")
        if chunks is None:
            chunks = guess_chunk(shape, itemsize)
        chunks = tuple(int(c) for c in chunks)
        msgs = [(0x01, 0, _encode_space(shape, maxshape)),
                (0x03, 1, stored),
                (0x05, 1, struct.pack("<4BI", 2, 3, 2, 1, 0))]
        if compression == "gzip":
            level = 4 if compression_opts is None else int(compression_opts)
            msgs.append((0x0B, 1, struct.pack("<BB6xHHHH", 1, 1, 1, 8, 1, 1)
                         + b"deflate\0" + struct.pack("<I4x", level)))
        msgs.append((0x08, 0, struct.pack("<BBBQ", 3, 2, len(shape) + 1, UNDEF)
                     + struct.pack(f"<{len(shape) + 1}I", *chunks, itemsize)))
        body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), fl) + _padded(d)
                        for t, fl, d in msgs)
        nmsgs = len(msgs)
        if len(body) < MIN_HEADER:
            body += struct.pack("<HHB3x", 0, MIN_HEADER - len(body) - 8, 0)
            body += bytes(MIN_HEADER - len(body))
            nmsgs += 1
        addr = self._alloc(16 + len(body))
        self._write(addr, struct.pack("<BBHII4x", 1, 0, nmsgs, 1, len(body))
                    + body)
        self._link(name, addr)
        self._flush_eof()
        return self[name]

    def _link(self, name: str, addr: int) -> None:
        """Add ``name`` -> ``addr`` to the root group's symbol table."""
        bt, heap = struct.unpack_from("<QQ", self._group(), 0)
        off = self._heap_insert(heap, name.encode() + b"\0")
        node = self._read(bt, 24)
        if node[5] != 0:
            raise FormatError("group B-tree of more than one level is not "
                              "written")
        n = _u16(node, 6)
        _, _, _, hdata = self._heap(heap)

        def name_at(o):
            return hdata[o:hdata.index(b"\0", o)]

        cap = 2 * self._leaf_k
        if n == 0:
            snod = self._alloc(8 + 40 * cap)
            entries = []
        else:
            if n != 1:
                raise FormatError("group of more than one symbol node is "
                                  "not written")
            snod = _u64(self._read(bt, 40), 32)
            entries = self._symbols(snod)
            if len(entries) >= cap:
                raise FormatError(f"group of more than {cap} members is not "
                                  f"written")
        entries.append((off, addr))
        entries.sort(key=lambda e: name_at(e[0]))
        img = b"SNOD" + struct.pack("<BBH", 1, 0, len(entries))
        for o, a in entries:
            img += struct.pack("<QQII16x", o, a, 0, 0)
        img += bytes(8 + 40 * cap - len(img))
        self._write(snod, img)
        self._extend()
        self._write(bt + 6, struct.pack("<HQQ", 1, UNDEF, UNDEF)
                    + struct.pack("<QQQ", 0, snod, entries[-1][0]))
        if self._members is not None:
            self._members[name] = addr

    def _heap_insert(self, heap_addr: int, data: bytes) -> int:
        """Place ``data`` in a free block of the local heap (the root of a
        new file has room for the names of a Digital RF file's two
        datasets)."""
        size, free, data_addr, hdata = self._heap(heap_addr)
        need = _pad8(len(data))
        prev, blk = None, free
        while blk != 1:
            nxt, bsize = struct.unpack_from("<QQ", hdata, blk)
            if bsize >= need:
                rest = bsize - need
                buf = bytearray(hdata)
                buf[blk:blk + need] = data + bytes(need - len(data))
                if rest >= 16:
                    new_free = blk + need
                    buf[new_free:new_free + 16] = struct.pack("<QQ", nxt, rest)
                else:
                    new_free = nxt
                if prev is None:
                    self._write(heap_addr + 16, _U64.pack(new_free))
                else:
                    buf[prev:prev + 8] = _U64.pack(new_free)
                self._write(data_addr, bytes(buf))
                return blk
            prev, blk = blk, nxt
        raise FormatError(f"local heap at {heap_addr} has no room for "
                          f"{len(data)} bytes")

    # ---- header edits (attributes)
    def _nil(self, h: _Header, m: _Msg) -> None:
        m.type = 0
        self._write(m.addr - 8, struct.pack("<HHB3x", 0, m.size, 0)
                    + bytes(m.size))
        h.data[m.addr] = bytes(m.size)

    def _place(self, h: _Header, m: _Msg, mtype: int, data: bytes) -> None:
        """Put a message into the NIL message ``m`` (splitting off the
        rest as a new NIL when it is large enough)."""
        rest = m.size - len(data)
        if rest >= 8:
            tail = _Msg(0, 0, m.addr + len(data) + 8, rest - 8)
            h.msgs.insert(h.msgs.index(m) + 1, tail)
            h.data[tail.addr] = bytes(tail.size)
            h.nmsgs += 1
            m.size = len(data)
            data += struct.pack("<HHB3x", 0, tail.size, 0) + bytes(tail.size)
        else:
            data += bytes(rest)
        m.type = mtype
        self._write(m.addr - 8, struct.pack("<HHB3x", mtype, m.size, 0) + data)
        h.data[m.addr] = data[:m.size]
        self._write(h.addr + 2, _U16.pack(h.nmsgs))

    def _add_message(self, h: _Header, mtype: int, data: bytes) -> None:
        data = _padded(data)
        n = len(data)
        for m in h.msgs:
            if m.type == 0 and m.size >= n + 24:
                return self._place(h, m, mtype, data)
        for m in h.msgs:
            if m.type == 0 and m.size >= 16:
                size = max(512, n + 8 + 24)
                blk = self._alloc(size)
                self._write(blk, struct.pack("<HHB3x", 0, size - 8, 0)
                            + bytes(size - 8))
                nil = _Msg(0, 0, blk + 8, size - 8)
                h.msgs.append(nil)
                h.data[nil.addr] = bytes(nil.size)
                h.nmsgs += 1
                self._place(h, m, 0x10, struct.pack("<QQ", blk, size))
                return self._add_message(h, mtype, data)
        raise FormatError(f"object header at {h.addr} is full")

    # ---- close
    def flush(self) -> None:
        if self.mode != "r" and self._fd >= 0:
            for ds in self._datasets.values():
                ds._flush_dims()
            self._flush_eof()

    def close(self) -> None:
        if self._fd >= 0:
            try:
                self.flush()
            finally:
                os.close(self._fd)
                self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_fd", -1) >= 0:
            os.close(self._fd)
            self._fd = -1
