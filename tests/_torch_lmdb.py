"""A writer of LMDB data files for the tests of the port's LMDB reader
(`ddgan_torch/data/lmdb.py`) and for `chip_smoke.py`, which loads this file
by path. It imports numpy and the standard library only.

`write_lmdb(directory, items)` writes `<directory>/data.mdb` in the layout
that the reader's docstring sets out (LMDB 0.9, `mdb.c`'s structs on a
64-bit little-endian build): two meta pages, then the main database's
B+tree built bottom up from the sorted keys, leaves first, each branch
level above them, with overflow runs for the values that LMDB puts on
overflow pages (a node of 8 + key + value bytes over `nodemax`,
`mdb_node_add`). `max_keys` caps the nodes a page holds, so that a few
entries make a deep tree. `older` writes a second, older tree first and
points the older meta page at it, so that a reader must pick the meta page
with the larger txnid. Real LMDB fills its pages differently (it splits
them at half); the reader does not depend on how full a page is.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path

PAGEHDRSZ = 16
NODESIZE = 8
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
MDB_MAGIC = 0xBEEFC0DE
P_INVALID = 2**64 - 1


def nodemax(psize: int) -> int:
    """The largest leaf node that stays on its page: me_nodemax of mdb.c
    (((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2) - sizeof(indx_t)."""
    return (((psize - PAGEHDRSZ) // 2) & -2) - 2


def ovpages(size: int, psize: int) -> int:
    """OVPAGES: the pages of an overflow run of `size` bytes."""
    return (PAGEHDRSZ - 1 + size) // psize + 1


def _even(n: int) -> int:
    return (n + 1) & -2


class _Pages:
    def __init__(self, psize: int):
        self.psize = psize
        self.data = bytearray(2 * psize)  # the two meta pages
        self.counts = {"branch": 0, "leaf": 0, "overflow": 0}

    @property
    def next_pgno(self) -> int:
        return len(self.data) // self.psize

    def add(self, n: int = 1) -> int:
        pgno = self.next_pgno
        self.data.extend(bytes(n * self.psize))
        return pgno

    def header(self, pgno: int, flags: int, lower: int, upper: int) -> None:
        struct.pack_into("<QHHHH", self.data, pgno * self.psize, pgno, 0, flags, lower, upper)

    def overflow(self, value: bytes) -> int:
        n = ovpages(len(value), self.psize)
        pgno = self.add(n)
        ofs = pgno * self.psize
        struct.pack_into("<QHHI", self.data, ofs, pgno, 0, P_OVERFLOW, n)
        self.data[ofs + PAGEHDRSZ:ofs + PAGEHDRSZ + len(value)] = value
        self.counts["overflow"] += n
        return pgno

    def node_page(self, flags: int, nodes: list) -> int:
        """One branch or leaf page of `nodes` ((lo, hi, nflags, key, data)),
        nodes placed from the page's end down, as mdb_node_add places them."""
        pgno = self.add()
        ofs = pgno * self.psize
        upper = self.psize
        for i, (lo, hi, nflags, key, data) in enumerate(nodes):
            size = _even(NODESIZE + len(key) + len(data))
            upper -= size
            struct.pack_into("<HHHH", self.data, ofs + upper, lo, hi, nflags, len(key))
            start = ofs + upper + NODESIZE
            self.data[start:start + len(key) + len(data)] = key + data
            struct.pack_into("<H", self.data, ofs + PAGEHDRSZ + 2 * i, upper)
        lower = PAGEHDRSZ + 2 * len(nodes)
        if lower > upper:
            raise ValueError(f"{len(nodes)} nodes overflow a {self.psize}-byte page")
        self.header(pgno, flags, lower, upper)
        self.counts["branch" if flags == P_BRANCH else "leaf"] += 1
        return pgno


def _fill(nodes: list, psize: int, max_keys: int | None) -> list[list]:
    """Nodes grouped into pages, greedily, at most `max_keys` a page."""
    pages, cur, used = [], [], PAGEHDRSZ
    for node in nodes:
        size = _even(NODESIZE + len(node[3]) + len(node[4])) + 2
        if cur and (used + size > psize or (max_keys and len(cur) >= max_keys)):
            pages.append(cur)
            cur, used = [], PAGEHDRSZ
        cur.append(node)
        used += size
    if cur:
        pages.append(cur)
    return pages


def _tree(pages: _Pages, items: dict, max_keys: int | None) -> dict:
    """The B+tree of `items`; its MDB_db fields."""
    before = dict(pages.counts)
    if not items:
        return {"depth": 0, "entries": 0, "root": P_INVALID, "branch": 0, "leaf": 0,
                "overflow": 0}
    leaf_nodes = []
    for key in sorted(items):
        key, value = bytes(key), bytes(items[key])
        if len(key) > 511:
            raise ValueError("LMDB keys are at most 511 bytes")
        size = len(value)
        if NODESIZE + len(key) + size > nodemax(pages.psize):
            data, flags = struct.pack("<Q", pages.overflow(value)), F_BIGDATA
        else:
            data, flags = value, 0
        leaf_nodes.append((size & 0xFFFF, size >> 16, flags, key, data))
    level = [(nodes[0][3], pages.node_page(P_LEAF, nodes))
             for nodes in _fill(leaf_nodes, pages.psize, max_keys)]
    depth = 1
    while len(level) > 1:
        branch_nodes = [(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF, pgno >> 32, key, b"")
                        for key, pgno in level]
        grouped = _fill(branch_nodes, pages.psize, max_keys)
        level = []
        for nodes in grouped:
            first = nodes[0][3]
            nodes[0] = nodes[0][:3] + (b"",) + nodes[0][4:]  # a branch page's first key is empty
            level.append((first, pages.node_page(P_BRANCH, nodes)))
        depth += 1
    return {"depth": depth, "entries": len(items), "root": level[0][1],
            **{k: pages.counts[k] - before[k] for k in before}}


def _meta(pages: _Pages, pgno: int, db: dict, txnid: int, last_pg: int) -> None:
    ofs = pgno * pages.psize
    struct.pack_into("<QHHHH", pages.data, ofs, pgno, 0, P_META, 0, 0)
    struct.pack_into("<IIQQ", pages.data, ofs + PAGEHDRSZ, MDB_MAGIC, 1, 0, 1 << 30)
    dbs = ofs + PAGEHDRSZ + 24
    # mm_dbs[FREE_DBI]: the page size in md_pad, an empty free list
    struct.pack_into("<IHHQQQQQ", pages.data, dbs, pages.psize, 0, 0, 0, 0, 0, 0, P_INVALID)
    struct.pack_into("<IHHQQQQQ", pages.data, dbs + 48, 0, 0, db["depth"], db["branch"],
                     db["leaf"], db["overflow"], db["entries"], db["root"])
    struct.pack_into("<QQ", pages.data, dbs + 96, last_pg, txnid)


def write_lmdb(directory, items: dict, *, psize: int = 4096, max_keys: int | None = None,
               txnid: int = 1, older: dict | None = None) -> dict:
    """Write `items` (bytes -> bytes) as `<directory>/data.mdb`. The newest
    meta page, with `txnid`, sits on page txnid & 1 as LMDB places it; the
    other holds txnid - 1 and either `older`'s tree or the same one.
    Returns the main database's fields and the file's size."""
    if txnid < 1:
        raise ValueError("txnid must be >= 1 (the older meta page holds txnid - 1)")
    pages = _Pages(psize)
    old = _tree(pages, older, max_keys) if older is not None else None
    new = _tree(pages, items, max_keys)
    last_pg = pages.next_pgno - 1
    _meta(pages, txnid & 1, new, txnid, last_pg)
    _meta(pages, 1 - (txnid & 1), old or new, txnid - 1, last_pg)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "data.mdb", "wb") as f:
        f.write(pages.data)
    return {**new, "bytes": os.path.getsize(directory / "data.mdb"), "psize": psize}
