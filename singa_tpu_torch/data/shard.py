"""Shard record files, bit-compatible with the reference's shard::Shard.

Wire format (reference: src/utils/shard.cc:49-67): a flat stream of tuples

    [8-byte LE keylen][key bytes][8-byte LE vallen][val bytes]

inside ``<folder>/shard.dat``. Semantics preserved from the reference:

- keys are deduplicated per writer session (Insert returns False on a
  duplicate key or empty value, shard.cc:50-52)
- kAppend mode scans the existing file, seeds the dedup key set, and
  truncates a torn final tuple left by a crash (PrepareForAppend,
  shard.cc:175-206)
- readers stream sequentially with buffered IO and stop cleanly at a torn
  tail (Next returns False, shard.cc:104-149)
"""

from __future__ import annotations

import os
import struct

_LEN = struct.Struct("<Q")  # size_t on the reference's 64-bit LE platforms


class ShardError(IOError):
    pass


def shard_path(folder: str) -> str:
    return os.path.join(folder, "shard.dat")


def _read_tuple(f, size: int) -> tuple[bytes, bytes] | None:
    """One complete [keylen key vallen val] tuple, or None at EOF/torn
    tail (file position restored). The single copy of the torn-tail
    arithmetic shared by the reader and the append pre-scan: lengths
    are bounded against ``size`` BEFORE the read, so a corrupt u64
    length surfaces as a torn tail, never OverflowError/MemoryError
    from read() — the native codec applies the same guard
    (shardcodec.cc). Fuzz-pinned in test_records_fuzz.py."""
    pos = f.tell()
    head = f.read(8)
    if len(head) < 8:
        f.seek(pos)
        return None
    keylen = _LEN.unpack(head)[0]
    if keylen > size - pos - 8:
        f.seek(pos)
        return None
    key = f.read(keylen)
    head = f.read(8)
    if len(key) < keylen or len(head) < 8:
        f.seek(pos)
        return None
    vallen = _LEN.unpack(head)[0]
    if vallen > size - pos - 16 - keylen:
        f.seek(pos)
        return None
    val = f.read(vallen)
    if len(val) < vallen:
        f.seek(pos)
        return None
    return key, val


class ShardWriter:
    """Create or append a shard (reference modes kCreate / kAppend)."""

    def __init__(self, folder: str, append: bool = False):
        os.makedirs(folder, exist_ok=True)
        self.path = shard_path(folder)
        self.keys: set[bytes] = set()
        if append and os.path.exists(self.path):
            valid_end = self._scan_existing()
            self._f = open(self.path, "r+b")
            self._f.truncate(valid_end)  # drop a torn tail write
            self._f.seek(valid_end)
        else:
            self._f = open(self.path, "wb")

    def _scan_existing(self) -> int:
        """Scan complete tuples, fill the key set, return the offset after
        the last complete tuple (PrepareForAppend, shard.cc:175-206);
        torn/corrupt tails stop the scan (_read_tuple)."""
        valid_end = 0
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            while (kv := _read_tuple(f, size)) is not None:
                self.keys.add(kv[0])
                valid_end = f.tell()
        return valid_end

    def insert(self, key: bytes | str, val: bytes) -> bool:
        """Append one tuple; False on duplicate key or empty value."""
        if isinstance(key, str):
            key = key.encode()
        if key in self.keys or not val:
            return False
        self.keys.add(key)
        self._f.write(_LEN.pack(len(key)))
        self._f.write(key)
        self._f.write(_LEN.pack(len(val)))
        self._f.write(val)
        return True

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardReader:
    """Sequential reader with wraparound (reference mode kRead)."""

    def __init__(self, folder: str, buffer_size: int = 1 << 20):
        self.path = shard_path(folder)
        if not os.path.exists(self.path):
            raise ShardError(f"no shard.dat under {folder!r}")
        self._bufsize = buffer_size
        self._f = open(self.path, "rb", buffering=buffer_size)
        # snapshot the size once: lengths are bounded against it in
        # next() (anything past the opened snapshot is a torn tail; a
        # per-record fstat would put a syscall on the training hot path)
        self._size = os.fstat(self._f.fileno()).st_size

    def next(self) -> tuple[bytes, bytes] | None:
        """Next (key, value), or None at EOF / torn tail (_read_tuple
        holds the shared torn-tail/corrupt-length arithmetic)."""
        return _read_tuple(self._f, self._size)

    def seek_to_first(self) -> None:
        self._f.seek(0)

    def count(self) -> int:
        """Number of complete tuples (reference: Shard::Count)."""
        pos = self._f.tell()
        self._f.seek(0)
        n = 0
        while self.next() is not None:
            n += 1
        self._f.seek(pos)
        return n

    def __iter__(self):
        while True:
            kv = self.next()
            if kv is None:
                return
            yield kv

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
