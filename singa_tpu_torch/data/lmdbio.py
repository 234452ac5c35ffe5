"""Pure-Python LMDB file codec (no liblmdb dependency): the port's copy
of ``singa_tpu/data/lmdbio.py``.

The reference's LMDBDataLayer reads Caffe image databases through liblmdb
(src/worker/layer.cc:237-328). This environment ships no lmdb binding, so
this module implements the LMDB 0.9 on-disk format directly:

* ``LMDBReader`` — a read-only cursor over ``data.mdb``: picks the newest
  valid meta page, walks the main DB's B+tree left-to-right, and yields
  ``(key, value)`` pairs in key order, following big-value overflow chains.
  This is the moral equivalent of ``mdb_cursor_get(MDB_NEXT)`` in the
  reference's cursor wraparound loop (layer.cc:276-303).
* ``write_lmdb`` — a minimal single-transaction writer producing a
  database (leaf + branch + overflow pages, twin meta pages) laid out per
  the LMDB 0.9 format notes below. Verified round-trippable by this
  reader AND by the independent native C++ walker
  (singa_tpu_torch/native/lmdbcodec.cc); compatibility with real liblmdb is by
  construction from the format, NOT verified — no liblmdb exists in this
  image to test against (checked: no system library, no python binding).

Format notes (LMDB 0.9, 64-bit little-endian layout — the only layout the
reference ever ran against):

    page header (16B): pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
                       (overflow pages reuse lower/upper as a u32 page count)
    node (8B hdr):     lo u16 | hi u16 | flags u16 | ksize u16 | key | data
        leaf:   datasize = lo | hi<<16; F_BIGDATA => data is u64 overflow pgno
        branch: child pgno = lo | hi<<16 | flags<<32
    meta (at +16):     magic u32 = 0xBEEFC0DE | version u32 = 1 | address u64
                       | mapsize u64 | MDB_db[2] | last_pg u64 | txnid u64
    MDB_db (48B):      pad u32 | flags u16 | depth u16 | branch u64 | leaf u64
                       | overflow u64 | entries u64 | root u64
    page size lives in mm_dbs[0].md_pad; main DB is mm_dbs[1].
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator

MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
P_INVALID = (1 << 64) - 1

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
P_SUBP = 0x40

# node flags
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
NODEHDRSZ = 8
METASZ = 4 + 4 + 8 + 8 + 48 * 2 + 8 + 8

_DB = struct.Struct("<IHHQQQQQ")  # MDB_db
_PAGEHDR = struct.Struct("<QHHHH")
_NODEHDR = struct.Struct("<HHHH")


class LMDBError(ValueError):
    pass


def lmdb_data_path(path: str) -> str:
    """Resolve a Caffe-style path: a directory containing data.mdb, or the
    data file itself (MDB_NOSUBDIR)."""
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class _Meta:
    __slots__ = (
        "psize", "depth", "branch_pages", "leaf_pages",
        "overflow_pages", "entries", "root", "last_pg", "txnid", "flags",
    )


def _parse_meta(buf: bytes, off: int) -> _Meta:
    magic, version = struct.unpack_from("<II", buf, off)
    if magic != MDB_MAGIC:
        raise LMDBError(f"bad meta magic {magic:#x}")
    if version != MDB_VERSION:
        raise LMDBError(f"unsupported LMDB data version {version}")
    m = _Meta()
    # skip address(8) + mapsize(8)
    free = _DB.unpack_from(buf, off + 24)
    main = _DB.unpack_from(buf, off + 24 + 48)
    m.psize = free[0]
    m.flags = main[1]
    m.depth = main[2]
    m.branch_pages = main[3]
    m.leaf_pages = main[4]
    m.overflow_pages = main[5]
    m.entries = main[6]
    m.root = main[7]
    m.last_pg, m.txnid = struct.unpack_from("<QQ", buf, off + 24 + 96)
    return m


class LMDBReader:
    """Sequential (key, value) iteration over an LMDB main database."""

    def __init__(self, path: str):
        self.path = lmdb_data_path(path)
        try:
            self._f = open(self.path, "rb")
        except OSError as e:
            raise LMDBError(f"cannot open LMDB at {path!r}: {e}") from e
        self._size = os.fstat(self._f.fileno()).st_size
        if self._size < 2 * 512:
            raise LMDBError(f"{self.path!r}: too small to be an LMDB file")
        metas = [self._try_meta(0, 0)]
        if metas[0] is not None:
            # meta 1 lives at the page size meta 0 declares
            metas.append(self._try_meta(metas[0].psize, 1))
        else:
            # meta 0 torn: scan plausible OS page sizes for meta 1
            for ps in (4096, 8192, 16384, 32768, 65536):
                m = self._try_meta(ps, 1)
                if m is not None and m.psize == ps:
                    metas.append(m)
                    break
        live = [m for m in metas if m is not None]
        if not live:
            raise LMDBError(f"{self.path!r}: no valid meta page")
        self.meta = max(live, key=lambda m: m.txnid)
        self.psize = self.meta.psize
        if self.psize < 512 or self.psize & (self.psize - 1):
            raise LMDBError(f"{self.path!r}: bad page size {self.psize}")
        self.entries = self.meta.entries
        if self.meta.flags & ~0x08:  # allow MDB_INTEGERKEY-free main dbs only
            raise LMDBError(
                f"{self.path!r}: main DB flags {self.meta.flags:#x} "
                "unsupported (dupsort/sub-databases)"
            )

    # -- low-level --

    def _try_meta(self, off: int, pgno: int) -> _Meta | None:
        """Parse the meta page at byte offset ``off``; None if invalid."""
        if off + PAGEHDRSZ + METASZ > self._size:
            return None
        buf = self._pread(off, PAGEHDRSZ + METASZ)
        hdr = _PAGEHDR.unpack_from(buf, 0)
        if not hdr[2] & P_META:
            return None  # torn/garbage: the twin meta may still be live
        try:
            return _parse_meta(buf, PAGEHDRSZ)
        except LMDBError:
            return None

    def _pread(self, off: int, n: int) -> bytes:
        # bound BEFORE seeking: a corrupt 48-bit page number times the
        # page size can exceed the OS offset range and make seek() raise
        # ValueError (fuzz-pinned) — every out-of-file read must be a
        # clean LMDBError instead
        if off < 0 or off + n > self._size:
            raise LMDBError(f"{self.path!r}: truncated read at {off}")
        self._f.seek(off)
        data = self._f.read(n)
        if len(data) < n:
            raise LMDBError(f"{self.path!r}: truncated read at {off}")
        return data

    def _page(self, pgno: int) -> bytes:
        # _pread holds the single authoritative out-of-file bound
        return self._pread(pgno * self.psize, self.psize)

    def _iter_page(
        self, pgno: int, visits: list[int], depth: int = 0
    ) -> Iterator[tuple[bytes, bytes]]:
        # guard corrupt/crafted B+trees the same way the native walker
        # does (native/lmdbcodec.cc): a depth cap plus a visit budget of
        # one traversal per page in the file, so a branch-page cycle
        # raises LMDBError instead of RecursionError. The budget is local
        # to each __iter__ call (concurrent iterators don't share it).
        if depth > 64:
            raise LMDBError(f"{self.path!r}: corrupt B+tree (depth > 64)")
        visits[0] += 1
        if visits[0] > max(1, self._size // self.psize):
            raise LMDBError(f"{self.path!r}: corrupt B+tree (page cycle)")
        page = self._page(pgno)
        _, _, flags, lower, _ = _PAGEHDR.unpack_from(page, 0)
        if flags & P_LEAF2:
            raise LMDBError("MDB_DUPFIXED leaf2 pages unsupported")
        nkeys = (lower - PAGEHDRSZ) >> 1
        if nkeys < 0 or lower > self.psize:
            raise LMDBError(f"{self.path!r}: corrupt page {pgno}")
        ptrs = struct.unpack_from(f"<{nkeys}H", page, PAGEHDRSZ)

        def node(off: int):
            # node offsets are raw u16s out of a possibly-corrupt page:
            # bound them (and the key bytes they declare) before any
            # unpack so corruption raises LMDBError, not struct.error
            if off < PAGEHDRSZ or off + NODEHDRSZ > self.psize:
                raise LMDBError(
                    f"{self.path!r}: corrupt node offset {off} in page "
                    f"{pgno}"
                )
            return _NODEHDR.unpack_from(page, off)

        if flags & P_BRANCH:
            for off in ptrs:
                lo, hi, nflags, _ = node(off)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child, visits, depth + 1)
        elif flags & P_LEAF:
            for off in ptrs:
                lo, hi, nflags, ksize = node(off)
                if nflags & (F_SUBDATA | F_DUPDATA):
                    raise LMDBError("dupsort/sub-database nodes unsupported")
                dsize = lo | (hi << 16)
                dstart = off + NODEHDRSZ + ksize
                if dstart > self.psize:
                    raise LMDBError(
                        f"{self.path!r}: corrupt leaf key in page {pgno}"
                    )
                key = page[off + NODEHDRSZ : dstart]
                if nflags & F_BIGDATA:
                    if dstart + 8 > self.psize:
                        raise LMDBError(
                            f"{self.path!r}: corrupt bigdata node in "
                            f"page {pgno}"
                        )
                    (ovpgno,) = struct.unpack_from("<Q", page, dstart)
                    yield key, self._read_overflow(ovpgno, dsize)
                else:
                    if dstart + dsize > self.psize:
                        raise LMDBError(
                            f"{self.path!r}: corrupt leaf value in page "
                            f"{pgno}"
                        )
                    yield key, page[dstart : dstart + dsize]
        else:
            raise LMDBError(
                f"{self.path!r}: page {pgno} has unexpected flags {flags:#x}"
            )

    def _read_overflow(self, pgno: int, size: int) -> bytes:
        hdr = self._pread(pgno * self.psize, PAGEHDRSZ)
        _, _, flags, lower, upper = _PAGEHDR.unpack_from(hdr, 0)
        if not flags & P_OVERFLOW:
            raise LMDBError(f"{self.path!r}: page {pgno} is not overflow")
        npages = lower | (upper << 16)  # pb_pages u32 overlays lower/upper
        if PAGEHDRSZ + size > npages * self.psize:
            raise LMDBError(f"{self.path!r}: overflow chain too short")
        return self._pread(pgno * self.psize + PAGEHDRSZ, size)

    # -- public --

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        if self.meta.root == P_INVALID:
            return
        yield from self._iter_page(self.meta.root, visits=[0])

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------


def _node_bytes(key: bytes, data: bytes, flags: int, dsize: int) -> bytes:
    lo = dsize & 0xFFFF
    hi = dsize >> 16
    if hi > 0xFFFF:
        raise LMDBError(f"value too large ({dsize} bytes)")
    return _NODEHDR.pack(lo, hi, flags, len(key)) + key + data


def write_lmdb(
    path: str,
    items: Iterable[tuple[bytes, bytes]],
    *,
    psize: int = 4096,
    map_size: int | None = None,
    assume_sorted: bool = False,
) -> int:
    """Write ``items`` as a fresh single-transaction LMDB database.

    ``path`` is created as a directory holding ``data.mdb`` + an empty
    ``lock.mdb`` (the layout Caffe and the reference expect). Items must be
    in ascending key order (LMDB's invariant): by default they are
    materialized and sorted here; ``assume_sorted=True`` streams an
    already-ordered iterable with O(page) memory — out-of-order keys raise.
    Pages are emitted to disk in strictly increasing pgno order, so the
    file is written sequentially (metas patched in last); peak memory is
    one page plus the pending branch-level key lists, never the dataset.
    Returns the number of entries.
    """
    if not assume_sorted:
        items = sorted(items, key=lambda kv: kv[0])
    nodemax = ((psize - PAGEHDRSZ) // 2) & ~1
    next_pg = 2  # 0, 1 are metas
    n_overflow = 0

    os.makedirs(path, exist_ok=True)
    data_path = lmdb_data_path(path)
    f = open(data_path, "wb")
    f.write(b"\x00" * (2 * psize))  # meta placeholders, patched at the end

    def alloc(n: int = 1) -> int:
        nonlocal next_pg
        pg = next_pg
        next_pg += n
        return pg

    def write_page(pgno: int, raw: bytes) -> None:
        assert f.tell() == pgno * psize, "pages must stream in pgno order"
        f.write(raw)

    def emit(pgno: int, flags: int, nodes: list[bytes]) -> None:
        ptrs: list[int] = []
        # readers (ours and liblmdb) only follow mp_ptrs, so packing nodes
        # downward from the page top keeps upper/lower honest
        upper = psize
        body = bytearray(psize)
        for node in nodes:
            ln = len(node) + (len(node) & 1)  # keep 2-byte alignment
            upper -= ln
            body[upper : upper + len(node)] = node
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(nodes)
        if lower > upper:
            raise LMDBError("page overflow during write (internal)")
        _PAGEHDR.pack_into(body, 0, pgno, 0, flags, lower, upper)
        struct.pack_into(f"<{len(ptrs)}H", body, PAGEHDRSZ, *ptrs)
        write_page(pgno, bytes(body))

    # ---- leaves (+ overflow chains) ----
    leaf_entries: list[tuple[bytes, int]] = []  # (first_key, pgno)
    cur_nodes: list[bytes] = []
    cur_first: bytes | None = None
    cur_used = 0

    def flush_leaf() -> None:
        nonlocal cur_nodes, cur_first, cur_used
        if not cur_nodes:
            return
        pg = alloc()
        emit(pg, P_LEAF, cur_nodes)
        leaf_entries.append((cur_first, pg))
        cur_nodes, cur_first, cur_used = [], None, 0

    n_items = 0
    prev_key: bytes | None = None
    for key, val in items:
        if not key or len(key) > 511:
            raise LMDBError(f"bad key length {len(key)}")
        if prev_key is not None and key <= prev_key:
            if key == prev_key:
                raise LMDBError(f"duplicate key {key!r}")
            raise LMDBError(
                f"keys out of order ({key!r} after {prev_key!r})"
            )
        prev_key = key
        n_items += 1
        # big values go to overflow pages; the chain streams out before the
        # node's leaf because leaves are allocated at flush time
        if NODEHDRSZ + len(key) + len(val) > nodemax:
            npg = (PAGEHDRSZ + len(val) + psize - 1) // psize
            ov = alloc(npg)
            n_overflow += npg
            chain = bytearray(npg * psize)
            _PAGEHDR.pack_into(chain, 0, ov, 0, P_OVERFLOW, npg & 0xFFFF,
                               npg >> 16)
            chain[PAGEHDRSZ : PAGEHDRSZ + len(val)] = val
            write_page(ov, bytes(chain))
            node = _node_bytes(key, struct.pack("<Q", ov), F_BIGDATA, len(val))
        else:
            node = _node_bytes(key, val, 0, len(val))
        need = len(node) + (len(node) & 1) + 2
        if cur_nodes and PAGEHDRSZ + cur_used + need > psize:
            flush_leaf()
        if cur_first is None:
            cur_first = key
        cur_nodes.append(node)
        cur_used += need
    flush_leaf()

    # ---- branches ----
    depth = 1 if leaf_entries else 0
    n_branch = 0
    level = leaf_entries
    while len(level) > 1:
        depth += 1
        next_level: list[tuple[bytes, int]] = []
        group: list[bytes] = []
        gfirst: bytes | None = None
        gused = 0

        def flush_branch() -> None:
            nonlocal group, gfirst, gused, n_branch
            if not group:
                return
            pg = alloc()
            emit(pg, P_BRANCH, group)
            n_branch += 1
            next_level.append((gfirst, pg))
            group, gfirst, gused = [], None, 0

        for i, (first_key, child) in enumerate(level):
            key = b"" if not group else first_key
            node = _NODEHDR.pack(
                child & 0xFFFF, (child >> 16) & 0xFFFF, child >> 32, len(key)
            ) + key
            need = len(node) + (len(node) & 1) + 2
            if group and PAGEHDRSZ + gused + need > psize:
                flush_branch()
                key = b""
                node = _NODEHDR.pack(
                    child & 0xFFFF, (child >> 16) & 0xFFFF, child >> 32, 0
                )
                need = len(node) + (len(node) & 1) + 2
            if gfirst is None:
                gfirst = first_key
            group.append(node)
            gused += need
        flush_branch()
        level = next_level

    root = level[0][1] if level else P_INVALID
    last_pg = next_pg - 1 if next_pg > 2 else 1

    # ---- metas (seek back and patch the placeholders) ----
    meta = bytearray(psize)
    free_db = _DB.pack(psize, 0, 0, 0, 0, 0, 0, P_INVALID)
    main_db = _DB.pack(
        0, 0, depth, n_branch, len(leaf_entries), n_overflow, n_items, root
    )
    if map_size is None:
        map_size = max(next_pg * psize, 1 << 20)
    body = struct.pack("<IIQQ", MDB_MAGIC, MDB_VERSION, 0, map_size)
    body += free_db + main_db + struct.pack("<QQ", last_pg, 1)
    for pg in (0, 1):
        _PAGEHDR.pack_into(meta, 0, pg, 0, P_META, 0, 0)
        meta[PAGEHDRSZ : PAGEHDRSZ + len(body)] = body
        f.seek(pg * psize)
        f.write(meta)
    f.close()
    lock = os.path.join(os.path.dirname(data_path), "lock.mdb")
    if not os.path.exists(lock):
        open(lock, "wb").close()
    return n_items
