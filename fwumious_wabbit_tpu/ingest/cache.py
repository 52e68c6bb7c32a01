"""Input record cache (.fwcache).

Same role and framing discipline as the reference's cache
(reference: src/cache.rs:12-232): parsed u32 records written verbatim with a
``FWCA`` magic + version + embedded namespace-map JSON header; the cache is
invalidated when the version or namespace map changes; writes go to a
``.writing`` temp file renamed into place on success.

Deviation from the reference: the reference compresses with LZ4 (for .gz
inputs); this build uses the standard library's zlib (level 1) for all
inputs — it needs no package beyond Python itself, and the cache is a local
artifact that is never exchanged with the reference engine. The header
records the codec; a cache in any other codec (earlier builds wrote zstd)
is stale and rebuilt.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..config.vwmap import VwNamespaceMap

CACHE_HEADER_MAGIC = b"FWCA"
CACHE_VERSION = 11  # tracks the reference's cache version (src/cache.rs:12)
CODEC_RAW = 0
CODEC_ZLIB = 1


class _ZlibWriter:
    """zlib (level 1) over a binary file: the bytes are cut into blocks of
    ``_BLOCK`` bytes, each compressed as a zlib stream of its own on a
    small thread pool (zlib releases the GIL, so compression overlaps the
    parse that feeds it) and written in order; an empty stream ends the
    file, so that a cut between two blocks is seen as truncation."""

    _BLOCK = 4 << 20
    _WORKERS = 3

    def __init__(self, fh):
        self._fh = fh
        self._pool = ThreadPoolExecutor(self._WORKERS,
                                        thread_name_prefix="fwcache-deflate")
        self._pending: deque = deque()
        self._parts: list = []
        self._size = 0

    def _submit(self, data: bytes) -> None:
        self._pending.append(self._pool.submit(zlib.compress, data, 1))
        while len(self._pending) > 2 * self._WORKERS:
            self._fh.write(self._pending.popleft().result())

    def write(self, data: bytes) -> None:
        self._parts.append(data)
        self._size += len(data)
        if self._size >= self._BLOCK:
            self._submit(b"".join(self._parts))
            self._parts, self._size = [], 0

    def finish(self) -> None:
        if self._parts:
            self._submit(b"".join(self._parts))
            self._parts, self._size = [], 0
        while self._pending:
            self._fh.write(self._pending.popleft().result())
        self._fh.write(zlib.compress(b"", 1))
        self._pool.shutdown()

    def close(self) -> None:
        """Drop what is not written yet (abort)."""
        self._pool.shutdown(cancel_futures=True)


class _ZlibReader:
    """Inflates :class:`_ZlibWriter`'s streams ahead on a thread of its
    own (zlib releases the GIL): ``read(n)`` returns up to n bytes of what
    is inflated, b"" at the end of the stream; the thread's errors are
    raised by ``read``."""

    _IN = 1 << 20
    _OUT = 8 << 20

    def __init__(self, fh):
        self._fh = fh
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._stop = threading.Event()
        self._rest = b""
        self._done = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fwcache-inflate")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _run(self) -> None:
        d = zlib.decompressobj()
        data = b""
        ended = False  # the last stream was the empty one that ends the file
        produced = 0  # bytes out of the current stream
        try:
            while True:
                if not data:
                    data = self._fh.read(self._IN)
                    if not data:
                        if ended:
                            break
                        raise ValueError("truncated cache file")
                out = d.decompress(data, self._OUT)
                ended = False
                produced += len(out)
                if out and not self._put(out):
                    return
                if d.eof:  # the next stream follows
                    data, d = d.unused_data, zlib.decompressobj()
                    ended, produced = produced == 0, 0
                else:
                    data = d.unconsumed_tail
            self._put(b"")
        except Exception as e:  # re-raised on the reading thread
            self._put(e)

    def read(self, size: int) -> bytes:
        if self._done:
            return b""
        chunk, self._rest = self._rest or self._q.get(), b""
        if isinstance(chunk, BaseException):
            self._done = True
            raise chunk
        if not chunk:
            self._done = True
            return b""
        chunk = memoryview(chunk)  # slices without copies
        if len(chunk) > size:
            chunk, self._rest = chunk[:size], chunk[size:]
        return bytes(chunk)

    def close(self) -> None:
        """Stop inflating ahead (for a reader left before its end)."""
        self._stop.set()
        self._thread.join()


class RecordCacheWriter:
    def __init__(self, final_path: str | Path, vw: VwNamespaceMap, compress: bool = True):
        self.final_path = str(final_path)
        self.tmp_path = self.final_path + ".writing"
        self._fh = open(self.tmp_path, "wb")
        vw_json = vw.to_source_json().encode()
        codec = CODEC_ZLIB if compress else CODEC_RAW
        self._fh.write(CACHE_HEADER_MAGIC)
        self._fh.write(struct.pack("<IIQ", CACHE_VERSION, codec, len(vw_json)))
        self._fh.write(vw_json)
        self._writer = _ZlibWriter(self._fh) if compress else self._fh

    def push_record(self, record: np.ndarray) -> None:
        self._writer.write(np.asarray(record, dtype=np.uint32).tobytes())

    def write_finish(self) -> None:
        if self._writer is not self._fh:
            self._writer.finish()
        self._fh.flush()
        self._fh.close()
        os.replace(self.tmp_path, self.final_path)

    def abort(self) -> None:
        try:
            if self._writer is not self._fh:
                self._writer.close()
            self._fh.close()
        finally:
            if os.path.exists(self.tmp_path):
                os.unlink(self.tmp_path)


class RecordCacheReader:
    """Iterates u32 records out of a cache file."""

    CHUNK = 1 << 20

    def __init__(self, path: str | Path, vw: VwNamespaceMap | None = None):
        self._fh = open(path, "rb")
        magic = self._fh.read(4)
        if magic != CACHE_HEADER_MAGIC:
            raise ValueError("Not a valid .fwcache file (bad magic)")
        version, codec, vw_len = struct.unpack("<IIQ", self._fh.read(16))
        if version != CACHE_VERSION:
            raise StaleCacheError(f"cache version {version} != {CACHE_VERSION}")
        vw_json = self._fh.read(vw_len).decode()
        if vw is not None and vw.to_source_json() != vw_json:
            raise StaleCacheError("namespace map changed; cache is stale")
        if codec == CODEC_ZLIB:
            self._reader = _ZlibReader(self._fh)
        elif codec == CODEC_RAW:
            self._reader = self._fh
        else:
            raise StaleCacheError(f"cache codec {codec} is not read by this "
                                  f"build")
        self._buf = b""

    def close(self) -> None:
        if self._reader is not self._fh:
            self._reader.close()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def read_chunk(self, size: int = 64 << 20) -> bytes:
        """Up to ``size`` raw decompressed bytes (bulk path for the native
        record translator); b"" at EOF."""
        return self._reader.read(size)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        while len(self._buf) < 4:
            chunk = self._reader.read(self.CHUNK)
            if not chunk:
                if self._buf:
                    raise ValueError("truncated cache file")
                raise StopIteration
            self._buf += chunk
        reclen_words = int(np.frombuffer(self._buf[:4], np.uint32)[0])
        need = reclen_words * 4
        while len(self._buf) < need:
            chunk = self._reader.read(self.CHUNK)
            if not chunk:
                raise ValueError("truncated cache file")
            self._buf += chunk
        rec = np.frombuffer(self._buf[:need], np.uint32).copy()
        self._buf = self._buf[need:]
        return rec


class StaleCacheError(Exception):
    pass


def cache_path_for(input_path: str | Path) -> str:
    return str(input_path) + ".fwcache"
