"""Host C++ of the port: built with g++ on first use, bound with ctypes.

`build(name, sources, libs)` compiles the sources into
`_build/<name>-<hash>.so` in the package, where the hash covers every source
file's bytes, the headers beside them and the flags, so a stale library is
never loaded. The library is written under a temporary name and moved into
place with `os.replace`, so no process ever loads a
half-written file; a lock file lets one process build while the others wait.
Nothing here runs at import time.

Libraries: `zstd_decode` (this directory; the checkpoint reader's zstd and
CRC-32C) and `vcpraster` (the PDF engine, `raster/cpp/`).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
# The PDF engine inflates Flate streams with zlib and renders on a thread pool.
RASTER_LIBS = ("-lz", "-lpthread")


def _compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found: the port's host libraries need a C++17 compiler")
    return found


def build(name: str, sources: Sequence[Path], libs: Sequence[str] = ()) -> Path:
    """Compile `sources` into `_build/<name>-<hash>.so` unless it is there;
    raise with the compiler's output if the build fails."""
    sources = [Path(s).resolve() for s in sources]
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *libs)).encode())
    for src in sources:
        for dep in sorted(src.parent.glob("*.h")) + [src]:
            h.update(dep.name.encode() + b"\0" + dep.read_bytes())
    lib = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # One build per library at a time: the others wait, then load its result.
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = BUILD_DIR / f".{name}-{os.getpid()}.so"
        proc = subprocess.run(
            [_compiler(), *CXX_FLAGS, *map(str, sources), "-o", str(tmp), *libs],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def build_zstd() -> Path:
    return build("zstd_decode", [_HERE / "zstd_decode.cc"])


@functools.lru_cache(maxsize=None)
def _zstd_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_zstd()))
    lib.vcp_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.vcp_zstd_decompress.restype = ctypes.c_int64
    lib.vcp_zstd_error.argtypes = [ctypes.c_int64]
    lib.vcp_zstd_error.restype = ctypes.c_char_p
    lib.vcp_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.vcp_crc32c.restype = ctypes.c_uint32
    return lib


class ZstdError(ValueError):
    pass


_DST_TOO_SMALL = 7  # the decoder's error code for a full output buffer


def zstd_decompress(data: bytes, size: Optional[int] = None, max_size: int = 1 << 27) -> bytearray:
    """Decode every zstd frame in `data`, back to back. With `size`, the
    output must be exactly that many bytes; without, the buffer grows as
    needed up to `max_size`. Raises ZstdError on corrupt input (bad tables or
    bitstreams, a checksum that does not match) and on a wrong size."""
    lib = _zstd_lib()
    data = bytes(data)
    # With a size, one spare byte makes a longer output fail instead of fitting.
    cap = size + 1 if size is not None else min(max_size, max(1 << 16, 4 * len(data)))
    while True:
        out = bytearray(cap)
        buf = (ctypes.c_char * cap).from_buffer(out)
        n = lib.vcp_zstd_decompress(data, len(data), ctypes.addressof(buf), cap)
        del buf
        if n == -_DST_TOO_SMALL and size is None and cap < max_size:
            cap = min(max_size, cap * 4)
            continue
        if n < 0:
            raise ZstdError(f"zstd: {lib.vcp_zstd_error(n).decode()}")
        if size is not None and n != size:
            raise ZstdError(f"zstd: decoded {n} bytes, expected {size}")
        del out[n:]
        return out


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    return _zstd_lib().vcp_crc32c(bytes(data), len(data))
