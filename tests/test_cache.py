"""Record cache round-trip + staleness tests (semantics from reference:
src/cache.rs:53-232)."""

import os

import numpy as np
import pytest

from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu.ingest.cache import (
    RecordCacheReader,
    RecordCacheWriter,
    StaleCacheError,
    cache_path_for,
)
from fwumious_wabbit_tpu.ingest.parser import VowpalParser

VW_MAP = "A,featureA\nB,featureB\n"


def test_roundtrip(tmp_path):
    vw = VwNamespaceMap.from_string(VW_MAP)
    parser = VowpalParser(vw)
    records = [
        parser.parse_line(b"1 |A a |B b\n").copy(),
        parser.parse_line(b"-1 |A a b c\n").copy(),
        parser.parse_line(b"|B x:3.5\n").copy(),
    ]
    path = tmp_path / "train.vw.fwcache"
    w = RecordCacheWriter(path, vw)
    for r in records:
        w.push_record(r)
    w.write_finish()

    got = list(RecordCacheReader(path, vw))
    assert len(got) == len(records)
    for a, b in zip(got, records):
        np.testing.assert_array_equal(a, b)


def test_atomic_write(tmp_path):
    vw = VwNamespaceMap.from_string(VW_MAP)
    path = tmp_path / "x.fwcache"
    w = RecordCacheWriter(path, vw)
    w.push_record(np.array([4, 1, 0, 5], np.uint32))
    # before finish, final path doesn't exist
    assert not path.exists()
    w.write_finish()
    assert path.exists()


def test_stale_on_vwmap_change(tmp_path):
    vw1 = VwNamespaceMap.from_string(VW_MAP)
    vw2 = VwNamespaceMap.from_string("A,featureA\nC,featureC\n")
    path = tmp_path / "y.fwcache"
    w = RecordCacheWriter(path, vw1)
    w.push_record(np.array([4, 1, 0, 5], np.uint32))
    w.write_finish()
    with pytest.raises(StaleCacheError):
        RecordCacheReader(path, vw2)


def test_cache_path_for():
    assert cache_path_for("/x/train.vw") == "/x/train.vw.fwcache"


def _big_records(n=40_000, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 32, int(rng.integers(4, 60)), dtype=np.uint64)
            .astype(np.uint32) for _ in range(n)]


@pytest.mark.parametrize("read_size", [1, 4093, 1 << 20, 64 << 20])
def test_roundtrip_across_compressor_blocks(tmp_path, monkeypatch, read_size):
    """Several compressor blocks and inflate chunks: the bytes read back in
    any read size are the bytes written."""
    from fwumious_wabbit_tpu.ingest import cache

    monkeypatch.setattr(cache._ZlibWriter, "_BLOCK", 1 << 16)
    monkeypatch.setattr(cache._ZlibReader, "_OUT", 1 << 15)
    vw = VwNamespaceMap.from_string(VW_MAP)
    path = tmp_path / "big.fwcache"
    recs = _big_records()
    w = RecordCacheWriter(path, vw)
    for r in recs:
        w.push_record(r)
    w.write_finish()
    want = b"".join(r.tobytes() for r in recs)
    with RecordCacheReader(path, vw) as rd:
        got = []
        while chunk := rd.read_chunk(read_size):
            got.append(chunk)
            if read_size == 1 and len(got) > 100:
                break  # one byte at a time: a prefix is enough
    got = b"".join(got)
    assert got == want[: len(got)]
    if read_size > 1:
        assert len(got) == len(want)
    assert isinstance(w._writer, cache._ZlibWriter)


@pytest.mark.parametrize("cut", ["inside_a_block", "between_blocks"])
def test_truncated_cache_raises_from_the_reader(tmp_path, monkeypatch, cut):
    import zlib

    from fwumious_wabbit_tpu.ingest import cache

    monkeypatch.setattr(cache._ZlibWriter, "_BLOCK", 1 << 14)
    vw = VwNamespaceMap.from_string(VW_MAP)
    path = tmp_path / "t.fwcache"
    w = RecordCacheWriter(path, vw)
    for r in _big_records(5_000):
        w.push_record(r)
    w.write_finish()
    data = path.read_bytes()
    end = zlib.compress(b"", 1)  # the empty stream that ends the file
    assert data.endswith(end)
    path.write_bytes(data[: len(data) - (200 if cut == "inside_a_block"
                                         else len(end))])
    with RecordCacheReader(path, vw) as rd:
        with pytest.raises(ValueError, match="truncated"):
            while rd.read_chunk(1 << 16):
                pass


def _threads(prefix):
    import threading

    return [t for t in threading.enumerate() if t.name.startswith(prefix)]


def test_abort_and_early_close_stop_the_threads(tmp_path, monkeypatch):
    from fwumious_wabbit_tpu.ingest import cache

    monkeypatch.setattr(cache._ZlibWriter, "_BLOCK", 1 << 12)
    monkeypatch.setattr(cache._ZlibReader, "_OUT", 1 << 10)
    vw = VwNamespaceMap.from_string(VW_MAP)
    path = tmp_path / "a.fwcache"
    w = RecordCacheWriter(path, vw)
    for r in _big_records(5_000):
        w.push_record(r)
    w.abort()
    assert not _threads("fwcache-deflate")
    assert not path.exists() and not os.path.exists(w.tmp_path)

    w = RecordCacheWriter(path, vw)
    for r in _big_records(20_000):
        w.push_record(r)
    w.write_finish()
    assert not _threads("fwcache-deflate")
    rd = RecordCacheReader(path, vw)  # its queue fills: it waits to put
    assert len(rd.read_chunk(10)) == 10
    rd.close()
    assert not _threads("fwcache-inflate")


def test_empty_cache_reads_empty(tmp_path):
    vw = VwNamespaceMap.from_string(VW_MAP)
    path = tmp_path / "e.fwcache"
    RecordCacheWriter(path, vw).write_finish()
    with RecordCacheReader(path, vw) as rd:
        assert rd.read_chunk() == b""
    assert list(RecordCacheReader(path, vw)) == []
