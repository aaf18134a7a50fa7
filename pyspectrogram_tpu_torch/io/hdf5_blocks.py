"""HDF5's checksummed metadata structures, read for io.hdf5.

Files written with ``libver`` v108 or later hold their metadata in blocks
that end in a Jenkins lookup3 checksum: version 2 object headers, fractal
heaps (dense attributes and links), version 2 B-trees (their name and
creation-order indexes, and chunk indexes), and the fixed and extensible
arrays that index chunks. This module reads those structures and checks
every checksum; a block whose checksum does not match raises OSError, as
h5py does, and nothing of it is returned. It also holds HDF5's fletcher32
checksum of filtered chunks.

Every reader takes the io.hdf5 File it reads from and calls only its
``_read(addr, n)`` (addresses relative to the superblock). Offsets and
lengths are 8 bytes wide (io.hdf5 refuses other superblocks).
"""

from __future__ import annotations

import errno
import functools
import math
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from pyspectrogram_tpu_torch.utils.errors import FormatError

UNDEF = 0xFFFF_FFFF_FFFF_FFFF
_M32 = 0xFFFF_FFFF
_Q = struct.Struct("<Q")
#: words of a fletcher32 block: i * w[i] summed over one stays in int64
_FLETCHER_BLOCK = 1 << 22


def _uint(b, p: int, n: int) -> int:
    return int.from_bytes(b[p:p + n], "little")


def _log2(n: int) -> int:
    """floor(log2(n)), 0 for 0 (HDF5's H5VM_log2_gen)."""
    return max(int(n).bit_length() - 1, 0)


def _enc_size(n: int) -> int:
    """Bytes HDF5 gives a count that may reach ``n`` (H5VM_limit_enc_size)."""
    return _log2(n) // 8 + 1


# ------------------------------------------------------------ checksums
def lookup3(data) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` with initval 0: HDF5's metadata
    checksum (H5_checksum_metadata)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n) & _M32
    if n == 0:
        return c
    pad = -n % 12
    w = np.frombuffer(bytes(data) + bytes(pad), "<u4").tolist()
    last = len(w) - 3
    for i in range(0, last, 3):
        a = (a + w[i]) & _M32
        b = (b + w[i + 1]) & _M32
        c = (c + w[i + 2]) & _M32
        a = (a - c) & _M32
        a ^= ((c << 4) | (c >> 28)) & _M32
        c = (c + b) & _M32
        b = (b - a) & _M32
        b ^= ((a << 6) | (a >> 26)) & _M32
        a = (a + c) & _M32
        c = (c - b) & _M32
        c ^= ((b << 8) | (b >> 24)) & _M32
        b = (b + a) & _M32
        a = (a - c) & _M32
        a ^= ((c << 16) | (c >> 16)) & _M32
        c = (c + b) & _M32
        b = (b - a) & _M32
        b ^= ((a << 19) | (a >> 13)) & _M32
        a = (a + c) & _M32
        c = (c - b) & _M32
        c ^= ((b << 4) | (b >> 28)) & _M32
        b = (b + a) & _M32
    a = (a + w[last]) & _M32
    b = (b + w[last + 1]) & _M32
    c = (c + w[last + 2]) & _M32
    c ^= b
    c = (c - (((b << 14) | (b >> 18)) & _M32)) & _M32
    a ^= c
    a = (a - (((c << 11) | (c >> 21)) & _M32)) & _M32
    b ^= a
    b = (b - (((a << 25) | (a >> 7)) & _M32)) & _M32
    c ^= b
    c = (c - (((b << 16) | (b >> 16)) & _M32)) & _M32
    a ^= c
    a = (a - (((c << 4) | (c >> 28)) & _M32)) & _M32
    b ^= a
    b = (b - (((a << 14) | (a >> 18)) & _M32)) & _M32
    c ^= b
    c = (c - (((b << 24) | (b >> 8)) & _M32)) & _M32
    return c


@functools.lru_cache(maxsize=1024)
def _lookup3_of(data: bytes) -> int:
    """lookup3 of one metadata block's bytes, remembered by content: a
    reader that opens the same files again (a live view's every tick)
    checks unchanged blocks without hashing them again."""
    return lookup3(data)


def checked(block, what: str, addr: int):
    """``block`` whose last 4 bytes hold the lookup3 checksum of what
    precedes them; OSError on a mismatch."""
    end = len(block) - 4
    if end < 0:
        raise OSError(errno.EIO, f"truncated {what} at {addr}")
    stored = struct.unpack_from("<I", block, end)[0]
    if _lookup3_of(bytes(block[:end])) != stored:
        raise OSError(errno.EIO, f"incorrect metadata checksum of the {what} "
                      f"at {addr}")
    return block


def fletcher32(data) -> int:
    """HDF5's fletcher32 of ``data`` (H5_checksum_fletcher32): big-endian
    16-bit words, an odd last byte as the high half of one more word, both
    sums folded to 16 bits. Computed with numpy: the folded sums are the
    true sums modulo 65535, except that a positive multiple of 65535 folds
    to 0xFFFF and only all-zero data gives 0. The second sum, the sum of
    every prefix sum, is m * sum(w) - sum(i * w[i]) over m words, taken in
    blocks that keep int64 from overflowing."""
    n = len(data)
    words = np.frombuffer(data, ">u2", n // 2).astype(np.int64)
    if n % 2:
        words = np.append(words, np.int64(data[-1]) << 8)
    m = len(words)
    s1 = s2 = 0
    for a in range(0, m, _FLETCHER_BLOCK):
        blk = words[a:a + _FLETCHER_BLOCK]
        t = int(blk.sum())
        s1 += t
        s2 += (m - a) * t - int(np.dot(np.arange(len(blk), dtype=np.int64),
                                       blk))
    if s1 == 0:
        return 0
    return ((s2 % 65535 or 0xFFFF) << 16) | (s1 % 65535 or 0xFFFF)


def strip_fletcher32(raw: bytes, where: str) -> bytes:
    """A chunk through the fletcher32 filter on read: its last 4 bytes
    (little-endian, or byte-reversed as HDF5 before 1.6.1 stored them)
    must be the checksum of the rest; OSError otherwise."""
    if len(raw) < 4:
        raise OSError(errno.EIO, f"fletcher32 chunk of {len(raw)} bytes in "
                      f"{where}")
    body, stored = raw[:-4], struct.unpack_from("<I", raw, len(raw) - 4)[0]
    want = fletcher32(body)
    if stored != want and stored != int.from_bytes(want.to_bytes(4, "little"),
                                                   "big"):
        raise OSError(errno.EIO, f"data error detected by fletcher32 "
                      f"checksum in {where}")
    return body


# ------------------------------------------------------------ fractal heap
HEAP_OBJECTS = {1: "huge", 2: "tiny"}

class FractalHeap:
    """A fractal heap (``FRHP``): its managed objects by heap ID. Huge
    objects and filtered heaps raise FormatError naming them; so do tiny
    objects, which no attribute or link message is small enough to be."""

    def __init__(self, f, addr: int):
        self.f, self.addr = f, addr
        b = f._read(addr, 146)
        if b[:4] != b"FRHP" or b[4] != 0:
            raise FormatError(f"fractal heap at {addr}")
        self.id_len, io_len, self.flags = struct.unpack_from("<HHB", b, 5)
        if io_len:
            raise FormatError(f"filtered fractal heap at {addr}")
        checked(b, "fractal heap header", addr)
        self.max_man = struct.unpack_from("<I", b, 10)[0]
        (self.width, self.start, self.max_direct, max_bits, _,
         self.root, self.rows) = struct.unpack_from("<HQQHHQH", b, 110)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((_log2(self.max_direct) + 7) // 8,
                            _enc_size(self.max_man))
        self.max_drows = _log2(self.max_direct) - _log2(self.start) + 2
        self.first_row_bits = _log2(self.start) + _log2(self.width)
        self._blocks: Dict[int, bytes] = {}

    def _row_size(self, r: int) -> int:
        return self.start if r == 0 else self.start << (r - 1)

    def get(self, heap_id: bytes) -> bytes:
        """The object a heap ID names."""
        kind = (heap_id[0] >> 4) & 3
        if heap_id[0] >> 6:
            raise FormatError(f"fractal heap ID version {heap_id[0] >> 6}")
        if kind:
            raise FormatError(f"{HEAP_OBJECTS.get(kind, 'unknown')} "
                              f"fractal heap object in the heap at "
                              f"{self.addr}")
        off = _uint(heap_id, 1, self.off_size)
        n = _uint(heap_id, 1 + self.off_size, self.len_size)
        if self.rows == 0:
            return self._direct(self.root, 0, self.start, off, n)
        return self._indirect(self.root, 0, self.rows, off, n)

    def _direct(self, addr, block_off, size, off, n) -> bytes:
        blk = self._blocks.get(addr)
        if blk is None:
            blk = self.f._read(addr, size)
            if blk[:4] != b"FHDB" or blk[4] != 0:
                raise FormatError(f"fractal heap direct block at {addr}")
            if self.flags & 2:
                # the checksum covers the whole block, its own field zeroed
                p = 13 + self.off_size
                stored = struct.unpack_from("<I", blk, p)[0]
                if lookup3(blk[:p] + bytes(4) + blk[p + 4:]) != stored:
                    raise OSError(errno.EIO, f"incorrect metadata checksum "
                                  f"of the fractal heap direct block at "
                                  f"{addr}")
            self._blocks[addr] = blk
        p = off - block_off
        if p < 0 or p + n > len(blk):
            raise FormatError(f"fractal heap object at offset {off} outside "
                              f"its block")
        return bytes(blk[p:p + n])

    def _indirect(self, addr, block_off, nrows, off, n) -> bytes:
        key = ("i", addr)
        blk = self._blocks.get(key)
        ndirect = min(nrows, self.max_drows) * self.width
        nindirect = max(nrows - self.max_drows, 0) * self.width
        if blk is None:
            size = 13 + self.off_size + 8 * (ndirect + nindirect) + 4
            blk = self.f._read(addr, size)
            if blk[:4] != b"FHIB" or blk[4] != 0:
                raise FormatError(f"fractal heap indirect block at {addr}")
            checked(blk, "fractal heap indirect block", addr)
            self._blocks[key] = blk
        p, start = off - block_off, 0
        for r in range(nrows):
            rs = self._row_size(r)
            if p < start + self.width * rs:
                col = (p - start) // rs
                child = _Q.unpack_from(blk, 13 + self.off_size
                                       + 8 * (r * self.width + col))[0]
                if child == UNDEF:
                    raise FormatError(f"fractal heap object at offset {off} "
                                      f"in an unallocated block")
                child_off = block_off + start + col * rs
                if r < self.max_drows:
                    return self._direct(child, child_off, rs, off, n)
                return self._indirect(child, child_off,
                                      _log2(rs) - self.first_row_bits + 1,
                                      off, n)
            start += self.width * rs
        raise FormatError(f"fractal heap offset {off} past its root block")


# ------------------------------------------------------------ v2 B-tree
def btree2_records(f, addr: int, rtype: int) -> List[bytes]:
    """Every record of the version 2 B-tree at ``addr``, in key order;
    the tree must hold records of type ``rtype``."""
    h = f._read(addr, 38)
    if h[:4] != b"BTHD" or h[4] != 0:
        raise FormatError(f"version 2 B-tree header at {addr}")
    checked(h, "version 2 B-tree header", addr)
    if h[5] != rtype:
        raise FormatError(f"version 2 B-tree of record type {h[5]} where "
                          f"type {rtype} belongs")
    node_size, rsize, depth = struct.unpack_from("<IHH", h, 6)
    root, root_n = struct.unpack_from("<QH", h, 16)
    # records a node holds at each depth, and the widths of its child counts
    max_n = [(node_size - 10) // rsize]
    nrec_size = _enc_size(max_n[0])
    cum = [max_n[0]]
    cum_size = [0]
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_n.append((node_size - 10 - ptr) // (rsize + ptr))
        cum.append((max_n[d] + 1) * cum[d - 1] + max_n[d])
        cum_size.append(_enc_size(cum[d]))
    out: List[bytes] = []

    def node(a, d, n):
        if d == 0:
            b = f._read(a, 6 + n * rsize + 4)
            if b[:4] != b"BTLF":
                raise FormatError(f"version 2 B-tree leaf at {a}")
            checked(b, "version 2 B-tree leaf", a)
            out.extend(bytes(b[6 + i * rsize:6 + (i + 1) * rsize])
                       for i in range(n))
            return
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        b = f._read(a, 6 + n * rsize + (n + 1) * ptr + 4)
        if b[:4] != b"BTIN":
            raise FormatError(f"version 2 B-tree internal node at {a}")
        checked(b, "version 2 B-tree internal node", a)
        p = 6 + n * rsize
        for i in range(n + 1):
            child = _Q.unpack_from(b, p)[0]
            cn = _uint(b, p + 8, nrec_size)
            node(child, d - 1, cn)
            if i < n:
                out.append(bytes(b[6 + i * rsize:6 + (i + 1) * rsize]))
            p += ptr

    if root != UNDEF and root_n:
        node(root, depth, root_n)
    return out


# ------------------------------------------------------------ chunk indexes
class ChunkGeometry:
    """What a chunk index needs of its dataset: chunk dims, the dataset's
    dims and max dims, the chunk's byte size, and whether its elements
    carry a stored size and filter mask."""

    def __init__(self, chunks, shape, maxshape, chunk_bytes, filtered):
        self.chunks, self.shape = tuple(chunks), tuple(shape)
        self.maxshape = tuple(maxshape)
        self.chunk_bytes, self.filtered = chunk_bytes, filtered
        # HDF5 keeps one spare byte for a chunk that its filters grew
        self.size_len = min(1 + (_log2(chunk_bytes) + 8) // 8, 8)

    def grid(self, dims) -> Tuple[int, ...]:
        return tuple(-(-int(d) // c) for d, c in zip(dims, self.chunks))

    def element(self, b, p) -> Tuple[int, int, int]:
        """(address, stored size, filter mask) of one index element."""
        addr = _Q.unpack_from(b, p)[0]
        if not self.filtered:
            return addr, self.chunk_bytes, 0
        size = _uint(b, p + 8, self.size_len)
        mask = struct.unpack_from("<I", b, p + 8 + self.size_len)[0]
        return addr, size, mask

    def elem_size(self) -> int:
        return 8 + (self.size_len + 4 if self.filtered else 0)


def _unravel(idx: int, grid) -> Tuple[int, ...]:
    out = []
    for g in reversed(grid):
        out.append(idx % g)
        idx //= g
    return tuple(reversed(out))


def _pages(f, addr, prefix, nelmts, page_n, esize, bitmap, what, bit0=0):
    """Element bytes of a paged data block: the pages that follow its
    prefix, each checked, None for a page the bitmap (from bit ``bit0``,
    most significant bit first) says is unwritten."""
    npages = -(-nelmts // page_n)
    out = []
    p = addr + prefix
    for i in range(npages):
        n = min(page_n, nelmts - i * page_n)
        size = n * esize + 4
        bit = bit0 + i
        if bitmap[bit // 8] & (0x80 >> (bit % 8)):
            out.append(checked(f._read(p, size), f"{what} page", p)[:-4])
        else:
            out.append(None)
        p += page_n * esize + 4
    return out


def fixed_array(f, addr: int, geom: ChunkGeometry):
    """[(element index, address, size, mask)] of a fixed-array index."""
    h = f._read(addr, 28)
    if h[:4] != b"FAHD" or h[4] != 0:
        raise FormatError(f"fixed array header at {addr}")
    checked(h, "fixed array header", addr)
    esize, page_bits = h[6], h[7]
    nelmts, dblk = struct.unpack_from("<QQ", h, 8)
    if esize != geom.elem_size():
        raise FormatError(f"fixed array elements of {esize} bytes")
    if dblk == UNDEF:
        return []
    page_n = 1 << page_bits
    if nelmts > page_n:
        npages = -(-nelmts // page_n)
        nbitmap = (npages + 7) // 8
        pre = checked(f._read(dblk, 14 + nbitmap + 4), "fixed array data "
                      "block", dblk)
        if pre[:4] != b"FADB":
            raise FormatError(f"fixed array data block at {dblk}")
        pages = _pages(f, dblk, 18 + nbitmap, nelmts, page_n, esize,
                       pre[14:14 + nbitmap], "fixed array data block")
    else:
        b = checked(f._read(dblk, 14 + nelmts * esize + 4),
                    "fixed array data block", dblk)
        if b[:4] != b"FADB":
            raise FormatError(f"fixed array data block at {dblk}")
        pages, page_n = [b[14:-4]], max(nelmts, 1)
    out = []
    for i, page in enumerate(pages):
        if page is None:
            continue
        for j in range(len(page) // esize):
            out.append((i * page_n + j,) + geom.element(page, j * esize))
    return out


def extensible_array(f, addr: int, geom: ChunkGeometry):
    """[(element index, address, size, mask)] of an extensible-array index:
    the elements in its index block, its data blocks, and the data blocks
    its secondary blocks list (paged ones page by page)."""
    h = f._read(addr, 12 + 6 * 8 + 8 + 4)
    if h[:4] != b"EAHD" or h[4] != 0:
        raise FormatError(f"extensible array header at {addr}")
    checked(h, "extensible array header", addr)
    esize, max_bits, iblk_n, dblk_min, sblk_min_ptrs, page_bits = h[6:12]
    iblk = _Q.unpack_from(h, 60)[0]
    if esize != geom.elem_size():
        raise FormatError(f"extensible array elements of {esize} bytes")
    if iblk == UNDEF:
        return []
    off_size = (max_bits + 7) // 8
    page_n = 1 << page_bits
    nsblks = 1 + max_bits - _log2(dblk_min)
    sblk = []                        # (ndblks, dblk nelmts, first element)
    start = 0
    for u in range(nsblks):
        nd, ne = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        sblk.append((nd, ne, start))
        start += nd * ne
    first_sblks = 2 * _log2(sblk_min_ptrs)
    ndblk_addrs = 2 * (sblk_min_ptrs - 1)
    nsblk_addrs = nsblks - first_sblks
    size = 14 + iblk_n * esize + 8 * (ndblk_addrs + nsblk_addrs) + 4
    b = checked(f._read(iblk, size), "extensible array index block", iblk)
    if b[:4] != b"EAIB":
        raise FormatError(f"extensible array index block at {iblk}")
    out = [(i,) + geom.element(b, 14 + i * esize) for i in range(iblk_n)]
    p = 14 + iblk_n * esize
    dblks = [_Q.unpack_from(b, p + 8 * i)[0] for i in range(ndblk_addrs)]
    p += 8 * ndblk_addrs
    sblks = [_Q.unpack_from(b, p + 8 * i)[0] for i in range(nsblk_addrs)]

    def data_block(a, ne, first, bitmap, bit0):
        if a == UNDEF:
            return
        if ne > page_n:
            pre = checked(f._read(a, 14 + off_size + 4),
                          "extensible array data block", a)
            if pre[:4] != b"EADB":
                raise FormatError(f"extensible array data block at {a}")
            pages = _pages(f, a, 18 + off_size, ne, page_n, esize, bitmap,
                           "extensible array data block", bit0)
            n_per = page_n
        else:
            blk = checked(f._read(a, 14 + off_size + ne * esize + 4),
                          "extensible array data block", a)
            if blk[:4] != b"EADB":
                raise FormatError(f"extensible array data block at {a}")
            pages, n_per = [blk[14 + off_size:-4]], ne
        for i, page in enumerate(pages):
            if page is None:
                continue
            for j in range(len(page) // esize):
                out.append((iblk_n + first + i * n_per + j,)
                           + geom.element(page, j * esize))

    k = 0
    for u in range(first_sblks):
        nd, ne, first = sblk[u]
        for j in range(nd):
            data_block(dblks[k], ne, first + j * ne, b"", 0)
            k += 1
    for u in range(first_sblks, nsblks):
        a = sblks[u - first_sblks]
        if a == UNDEF:
            continue
        nd, ne, first = sblk[u]
        npages = -(-ne // page_n) if ne > page_n else 0
        nbitmap = (npages + 7) // 8
        size = 14 + off_size + nd * nbitmap + 8 * nd + 4
        s = checked(f._read(a, size), "extensible array secondary block", a)
        if s[:4] != b"EASB":
            raise FormatError(f"extensible array secondary block at {a}")
        # one bitmap for the whole block: data block j's pages from bit
        # j * npages on
        q = 14 + off_size
        bitmap = s[q:q + nd * nbitmap]
        q += nd * nbitmap
        for j in range(nd):
            data_block(_Q.unpack_from(s, q + 8 * j)[0], ne, first + j * ne,
                       bitmap, j * npages)
    return out


def btree2_chunks(f, addr: int, geom: ChunkGeometry):
    """[(scaled chunk offsets, address, size, mask)] of a version 2 B-tree
    chunk index (record type 10, or 11 for filtered chunks)."""
    rank = len(geom.chunks)
    out = []
    for r in btree2_records(f, addr, 11 if geom.filtered else 10):
        a, size, mask = geom.element(r, 0)
        p = 8 + (geom.size_len + 4 if geom.filtered else 0)
        out.append((struct.unpack_from(f"<{rank}Q", r, p), a, size, mask))
    return out


def linear_index(geom: ChunkGeometry, unlimited: Optional[int] = None):
    """Element index -> scaled chunk offsets, for the fixed and extensible
    arrays and the implicit index: row-major over the grid of max dims,
    with an extensible array's unlimited axis moved first."""
    grid = list(geom.grid(geom.maxshape if unlimited is None else
                          [m if m is not None else 1 for m in geom.maxshape]))
    if unlimited is None:
        return lambda i: _unravel(i, grid)
    rest = [g for k, g in enumerate(grid) if k != unlimited]
    inner = math.prod(rest)

    def convert(i):
        sub = _unravel(i % inner, rest) if rest else ()
        out = list(sub)
        out.insert(unlimited, i // inner)
        return tuple(out)

    return convert
