"""weight_patcher — byte-level model-file diff/patch.

Same on-disk format as the reference's standalone patcher binary
(reference: weight_patcher/src/main.rs:52-266): a gzip stream of
(LEB128-varint index delta, raw new byte) entries. The C++ tool
(native/weight_patcher.cpp) is the fast path; this module provides the same
operations in Python (used as fallback and as the cross-check oracle in
tests) plus a CLI:

    python -m fwumious_wabbit_tpu.tools.weight_patcher create_diff A B diff
    python -m fwumious_wabbit_tpu.tools.weight_patcher recreate A diff out
"""

from __future__ import annotations

import gzip
import subprocess
import sys
from pathlib import Path

_NATIVE = Path(__file__).resolve().parent.parent / "native" / "weight_patcher"


def native_binary() -> Path | None:
    """The C++ patcher (native/weight_patcher.cpp), built on first use;
    None when it cannot be built (it links zlib)."""
    if not _NATIVE.exists():
        r = subprocess.run(["make", "-C", str(_NATIVE.parent), "-s",
                            _NATIVE.name], capture_output=True, text=True)
        if r.returncode != 0:
            return None
    return _NATIVE


def _write_varint(out: bytearray, value: int) -> None:
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def create_diff_bytes(a: bytes, b: bytes) -> bytes:
    """Diff payload (uncompressed) between equal-length byte strings."""
    out = bytearray()
    prev = 0
    n = max(len(a), len(b))
    for i in range(n):
        av = a[i] if i < len(a) else None
        bv = b[i] if i < len(b) else None
        if av != bv:
            _write_varint(out, i - prev)
            out.append(bv if bv is not None else 0)
            prev = i
    return bytes(out)


def recreate_bytes(a: bytes, diff: bytes) -> bytes:
    """Apply an uncompressed diff payload to ``a``."""
    out = bytearray(a)
    pos = 0
    index = 0
    first = True
    while pos < len(diff):
        delta = 0
        shift = 0
        while True:
            byte = diff[pos]
            pos += 1
            delta |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        to = diff[pos]
        pos += 1
        index = delta if first else index + delta
        first = False
        if index < len(out):
            out[index] = to
    return bytes(out)


def create_diff(a_path, b_path, diff_path, use_native: bool = True) -> None:
    if use_native and native_binary() is not None:
        subprocess.run(
            [str(_NATIVE), "create_diff", str(a_path), str(b_path), str(diff_path)],
            check=True,
        )
        return
    payload = create_diff_bytes(Path(a_path).read_bytes(), Path(b_path).read_bytes())
    Path(diff_path).write_bytes(gzip.compress(payload, compresslevel=6))


def recreate(a_path, diff_path, out_path, use_native: bool = True) -> None:
    if use_native and native_binary() is not None:
        subprocess.run(
            [str(_NATIVE), "recreate", str(a_path), str(diff_path), str(out_path)],
            check=True,
        )
        return
    payload = gzip.decompress(Path(diff_path).read_bytes())
    Path(out_path).write_bytes(recreate_bytes(Path(a_path).read_bytes(), payload))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 4 or argv[0] not in ("create_diff", "recreate"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "create_diff":
        create_diff(argv[1], argv[2], argv[3])
    else:
        recreate(argv[1], argv[2], argv[3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
