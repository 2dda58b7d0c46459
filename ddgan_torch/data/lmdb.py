"""A read-only LMDB reader of the port's own, over `mmap`.

The counterpart of what `ddgan_tpu/data/lmdb_datasets.py` asks of the
`lmdb` package, with its names: `open(path, readonly=True, lock=False,
...)`, `Environment.begin()`, `Transaction.get(key)`,
`Transaction.stat()["entries"]` and `Transaction.cursor().iternext(keys=True,
values=False)`, and no more. It reads the `subdir=True` layout that `lmdb.open(root)`
writes, `<path>/data.mdb`, takes no lock and writes nothing.

The layout it assumes, by the struct names of LMDB's `mdb.c` (LMDB 0.9, a
64-bit little-endian build: `pgno_t`, `size_t` and `txnid_t` are 8 bytes):

  * The file is an array of pages of `psize` bytes; page p starts at
    p * psize.
  * The page header `MDB_page` is 16 bytes (PAGEHDRSZ): `mp_pgno` (u64),
    `mp_pad` (u16), `mp_flags` (u16), then `mp_lower` and `mp_upper` (u16
    each), or `mp_pages` (u32) on an overflow page. Then come `mp_ptrs`,
    one u16 a node: the node's byte offset from the page's start. A page
    holds (mp_lower - 16) / 2 nodes.
  * Page flags: P_BRANCH 0x01, P_LEAF 0x02, P_OVERFLOW 0x04, P_META 0x08,
    P_LEAF2 0x20 (only in DUPFIXED sub-databases: raises).
  * Pages 0 and 1 are meta pages (P_META). After the header comes
    `MDB_meta`: `mm_magic` (u32, 0xBEEFC0DE), `mm_version` (u32, 1),
    `mm_address` (u64), `mm_mapsize` (u64), `mm_dbs[2]` (two `MDB_db`),
    `mm_last_pg` (u64) and `mm_txnid` (u64). Both must be valid, as
    `mdb_env_read_header` requires; the one with the larger `mm_txnid` is
    the database (page 0 on a tie). Page 1 sits at the `psize` of page 0.
  * `MDB_db` is 48 bytes: `md_pad` (u32), `md_flags` (u16), `md_depth`
    (u16), `md_branch_pages`, `md_leaf_pages`, `md_overflow_pages`,
    `md_entries` and `md_root` (u64 each). `mm_dbs[FREE_DBI]` (0) holds the
    page size in its `md_pad`; `mm_dbs[MAIN_DBI]` (1) is the database read
    here. `md_root` is P_INVALID (2**64 - 1) for an empty tree. A main
    database with flags (reverse or integer keys, duplicates) raises.
  * `MDB_node` is 8 bytes before its key: `mn_lo`, `mn_hi`, `mn_flags`,
    `mn_ksize` (u16 each), then the key, then the data. On a branch page
    the child's pgno is `lo | hi << 16 | flags << 32`, and the first
    node's key is empty: it stands for every key below the second one. On a
    leaf page the data size is `lo | hi << 16`.
  * A leaf node with F_BIGDATA (0x01) holds, as its data, the u64 pgno of
    an overflow run: a page with P_OVERFLOW and `mp_pages` pages, the value
    starting right after that page's header. F_SUBDATA (0x02) and
    F_DUPDATA (0x04) raise: no DDGAN LMDB (CelebA-HQ, LSUN) uses them.
  * Keys compare bytewise, a shorter key first on a common prefix
    (`mdb_cmp_memn`), as Python compares `bytes`: so "10" < "2" among
    CelebA's `str(index)` keys.

`get` walks the tree from the root by binary search and builds no index of
the database (LSUN bedroom train holds ~3M entries). The cursor walks the
leaves in key order. A file that is not an LMDB, or is cut short, raises
ValueError naming its path.
"""

from __future__ import annotations

import builtins
import mmap
import os
import struct
from typing import Iterator

PAGEHDRSZ = 16
NODESIZE = 8
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
P_INVALID = 2**64 - 1
FREE_DBI, MAIN_DBI = 0, 1

_HEADER = struct.Struct("<QHHHH")  # mp_pgno, mp_pad, mp_flags, mp_lower, mp_upper
_OVERFLOW_PAGES = struct.Struct("<I")  # mp_pages, where mp_lower / mp_upper sit
_META = struct.Struct("<IIQQ")  # mm_magic, mm_version, mm_address, mm_mapsize
_DB = struct.Struct("<IHHQQQQQ")  # MDB_db
_NODE = struct.Struct("<HHHH")  # mn_lo, mn_hi, mn_flags, mn_ksize
_U64 = struct.Struct("<Q")
_META_SIZE = _META.size + 2 * _DB.size + 16  # ... mm_last_pg, mm_txnid


class _File:
    """The pages of one data.mdb and its main database's root."""

    def __init__(self, path: str):
        self.path = path
        with builtins.open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < PAGEHDRSZ + _META_SIZE:
                raise ValueError(f"{path}: {size} bytes is too short for an LMDB meta page")
            self.buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self.size = size
        first = self._meta(0)
        self.psize = first["psize"]
        if not (64 <= self.psize <= 65536 and self.psize & (self.psize - 1) == 0):
            raise ValueError(f"{path}: page size {self.psize} is not an LMDB page size")
        if size < 2 * self.psize:
            raise ValueError(f"{path}: {size} bytes cannot hold two meta pages of "
                             f"{self.psize} bytes (truncated)")
        second = self._meta(self.psize)
        meta = second if second["txnid"] > first["txnid"] else first
        if meta["flags"]:
            raise ValueError(f"{path}: the main database has flags {meta['flags']:#x} "
                             "(reverse, integer or duplicate keys), which this reader does not "
                             "read")
        self.root, self.depth, self.entries = meta["root"], meta["depth"], meta["entries"]
        self.txnid = meta["txnid"]

    def _meta(self, ofs: int) -> dict:
        _, _, flags, _, _ = _HEADER.unpack_from(self.buf, ofs)
        magic, version, _, _ = _META.unpack_from(self.buf, ofs + PAGEHDRSZ)
        if not flags & P_META or magic != MDB_MAGIC:
            raise ValueError(f"{self.path}: not an LMDB data file (the page at byte {ofs} has "
                             f"flags {flags:#x} and magic {magic:#x}, not a meta page)")
        if version != MDB_DATA_VERSION:
            raise ValueError(f"{self.path}: LMDB data version {version}, this reader reads "
                             f"{MDB_DATA_VERSION}")
        dbs = ofs + PAGEHDRSZ + _META.size
        psize = _DB.unpack_from(self.buf, dbs)[0]  # mm_dbs[FREE_DBI].md_pad
        _, flags, depth, _, _, _, entries, root = _DB.unpack_from(self.buf, dbs + _DB.size)
        txnid = _U64.unpack_from(self.buf, dbs + 2 * _DB.size + 8)[0]
        return {"psize": psize, "flags": flags, "depth": depth, "entries": entries,
                "root": root, "txnid": txnid}

    def page(self, pgno: int, pages: int = 1) -> int:
        """The byte offset of page `pgno`, checked to lie in the file with
        the `pages` - 1 pages after it."""
        ofs = pgno * self.psize
        if pgno >= P_INVALID or ofs + pages * self.psize > self.size:
            raise ValueError(f"{self.path}: page {pgno} (+{pages - 1}) lies past the end of the "
                             f"file ({self.size} bytes; truncated?)")
        return ofs

    def nodes(self, pgno: int) -> tuple[int, int, list[int]]:
        """(page offset, flags, node offsets) of a branch or leaf page."""
        ofs = self.page(pgno)
        _, _, flags, lower, upper = _HEADER.unpack_from(self.buf, ofs)
        if flags & P_LEAF2 or not flags & (P_BRANCH | P_LEAF):
            raise ValueError(f"{self.path}: page {pgno} has flags {flags:#x}, not a branch or "
                             "leaf page of the main database")
        n = (lower - PAGEHDRSZ) // 2
        if lower < PAGEHDRSZ or upper > self.psize or n * 2 + PAGEHDRSZ > upper:
            raise ValueError(f"{self.path}: page {pgno} has mp_lower {lower}, mp_upper {upper}")
        ptrs = struct.unpack_from(f"<{n}H", self.buf, ofs + PAGEHDRSZ)
        return ofs, flags, [ofs + p for p in ptrs]

    def node(self, at: int) -> tuple[int, int, int, bytes]:
        """(lo | hi << 16, flags, data offset, key) of the node at byte `at`."""
        lo, hi, flags, ksize = _NODE.unpack_from(self.buf, at)
        key = self.buf[at + NODESIZE:at + NODESIZE + ksize]
        return lo | hi << 16, flags, at + NODESIZE + ksize, key

    def child(self, at: int) -> int:
        lo, hi, flags, _ = _NODE.unpack_from(self.buf, at)
        return lo | hi << 16 | flags << 32

    def value(self, at: int) -> bytes:
        size, flags, data, key = self.node(at)
        if flags & (F_SUBDATA | F_DUPDATA):
            raise ValueError(f"{self.path}: key {key!r} holds a sub-database or duplicates "
                             f"(node flags {flags:#x}), which this reader does not read")
        if flags & F_BIGDATA:
            pgno = _U64.unpack_from(self.buf, data)[0]
            ofs = self.page(pgno)
            _, _, pflags, _, _ = _HEADER.unpack_from(self.buf, ofs)
            pages = _OVERFLOW_PAGES.unpack_from(self.buf, ofs + 12)[0]
            if not pflags & P_OVERFLOW or PAGEHDRSZ + size > pages * self.psize:
                raise ValueError(f"{self.path}: key {key!r} points at page {pgno}, not an "
                                 f"overflow run of {size} bytes")
            self.page(pgno, pages)
            data = ofs + PAGEHDRSZ
        if data + size > self.size:
            raise ValueError(f"{self.path}: the value of {key!r} lies past the end of the file")
        return self.buf[data:data + size]

    def get(self, key: bytes) -> bytes | None:
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(max(self.depth, 1) + 1):
            _, flags, nodes = self.nodes(pgno)
            if flags & P_LEAF:
                lo, hi = 0, len(nodes)
                while lo < hi:  # the first node whose key is >= key
                    mid = (lo + hi) // 2
                    if self.node(nodes[mid])[3] < key:
                        lo = mid + 1
                    else:
                        hi = mid
                if lo < len(nodes) and self.node(nodes[lo])[3] == key:
                    return self.value(nodes[lo])
                return None
            lo, hi = 1, len(nodes)
            while lo < hi:  # the first node past 0 whose key is > key
                mid = (lo + hi) // 2
                if self.node(nodes[mid])[3] <= key:
                    lo = mid + 1
                else:
                    hi = mid
            pgno = self.child(nodes[lo - 1])
        raise ValueError(f"{self.path}: no leaf within the tree's depth {self.depth}")

    def keys(self) -> Iterator[bytes]:
        """Every key in key order: a depth-first walk."""
        if self.root == P_INVALID:
            return
        stack = [(self.root, 0)]
        while stack:
            pgno, level = stack.pop()
            if level > max(self.depth, 1):
                raise ValueError(f"{self.path}: page {pgno} lies below the tree's depth "
                                 f"{self.depth}")
            _, flags, nodes = self.nodes(pgno)
            if flags & P_LEAF:
                yield from (self.node(at)[3] for at in nodes)
            else:
                stack.extend((self.child(at), level + 1) for at in reversed(nodes))


class Cursor:
    def __init__(self, file: _File):
        self._file = file

    def iternext(self, keys: bool = True, values: bool = False) -> Iterator[bytes]:
        """Every key in key order, as py-lmdb's `iternext(keys=True,
        values=False)`: the one form the datasets use."""
        if not keys or values:
            raise ValueError("this LMDB reader's cursor yields keys only")
        return self._file.keys()


class Transaction:
    """A read transaction: the database as the newest meta page has it."""

    def __init__(self, file: _File):
        self._file = file

    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def get(self, key: bytes) -> bytes | None:
        return self._file.get(bytes(key))

    def stat(self) -> dict:
        return {"psize": self._file.psize, "depth": self._file.depth,
                "entries": self._file.entries}

    def cursor(self) -> Cursor:
        return Cursor(self._file)


class Environment:
    def __init__(self, path: str):
        self.path = path
        self._file = _File(os.path.join(path, "data.mdb"))

    def begin(self, write: bool = False, buffers: bool = False) -> Transaction:
        """A read transaction. `buffers` is accepted and ignored: values
        come back as bytes (a copy), not as buffers into the map."""
        del buffers
        if write:
            raise ValueError(f"{self.path}: this LMDB reader is read-only")
        return Transaction(self._file)


def open(path: str, readonly: bool = True, lock: bool = False, max_readers: int = 126,  # noqa: A001
         readahead: bool = True, meminit: bool = True) -> Environment:
    """The LMDB environment in directory `path` (its data.mdb), read-only.
    `lock`, `max_readers`, `readahead` and `meminit` are py-lmdb's options
    that the DDGAN datasets pass; a reader without a lock file ignores them."""
    del lock, max_readers, readahead, meminit
    if not readonly:
        raise ValueError(f"{path}: this LMDB reader is read-only (readonly=True)")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no LMDB directory (expected {path}/data.mdb)")
    return Environment(path)
