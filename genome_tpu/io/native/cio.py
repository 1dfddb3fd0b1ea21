"""ctypes binding for the native FASTA/FASTQ parser (T0 fast path).

Compiles genome_tpu/io/native/fastx_native.cpp on first use with g++
(cached in the checkout's git-ignored `.native_build/`, or under
$GENOME_TPU_CACHE, keyed by source hash) and falls back to
the pure-Python parser transparently if no toolchain is available —
correctness never depends on the native path (same contract, CI-compared).
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "fastx_native.cpp")
_LIB = None
_TRIED = False

_ERRORS = {
    -1: "empty input",
    -2: "not FASTA/FASTQ",
    -3: "truncated record",
    -4: "row overflow",
}


def _cache_dir() -> str:
    from genome_tpu.runtime import REPO_ROOT
    d = os.environ.get("GENOME_TPU_CACHE",
                       os.path.join(REPO_ROOT, ".native_build"))
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_cache_dir(), f"fastx_native_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, "fastx_native.so")
        cmd = ["g++", "-O3", "-pthread", "-shared", "-fPIC", "-std=c++17",
               _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so_path)
    return so_path


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.gt_scan.restype = ctypes.c_int64
    lib.gt_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_int64),
                            ctypes.POINTER(ctypes.c_int64)]
    lib.gt_parse.restype = ctypes.c_int64
    lib.gt_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.gt_index.restype = ctypes.c_int64
    lib.gt_index.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int64]
    lib.gt_parse_mt.restype = ctypes.c_int64
    lib.gt_parse_mt.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int64]
    lib.gt_pack_codes.restype = ctypes.c_int64
    lib.gt_pack_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _map_file(path: str):
    """(buffer, n): mmap for plain files (zero-copy), bytes for .gz."""
    if os.fspath(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            data = f.read()
        return data, len(data)
    size = os.path.getsize(path)
    if size == 0:
        return b"", 0
    import mmap as _mmap
    with open(path, "rb") as f:
        # COPY access: pages lazily like ACCESS_READ but exposes a
        # writable buffer, which ctypes.from_buffer requires
        mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_COPY)
    return mm, size


def _as_cptr(buf):
    if isinstance(buf, bytes):
        return ctypes.c_char_p(buf)
    arr = (ctypes.c_char * len(buf)).from_buffer(buf)
    return ctypes.cast(arr, ctypes.c_char_p)


def _parse_python(data: bytes, length: int | None) -> np.ndarray:
    """Fallback: reuse the Python parser + encoder."""
    import io as _io
    from genome_tpu.io.fastx import _iter_fasta, _iter_fastq
    from genome_tpu.kernels.extract import pack_reads

    text = _io.TextIOWrapper(_io.BytesIO(data))
    first = text.read(1)
    if not first:
        return np.full((0, length or 0), 4, dtype=np.uint8)
    if first == ">":
        seqs = [s for _, s in _iter_fasta(text)]
    elif first == "@":
        seqs = [s for _, s in _iter_fastq(text)]
    else:
        raise ValueError("not FASTA/FASTQ")
    return pack_reads(seqs, length)


def pack_codes_native(codes: np.ndarray, threads: int | None = None,
                      L_out: int | None = None, rows_out: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray] | None:
    """Native row-parallel packing of a [B, L] uint8 code matrix into the
    device wire format (4 codes/byte + invalid bitmask). Byte-identical
    to kernels.extract.pack_codes_host's numpy path (CI-compared);
    returns None when the native library is unavailable or the input is
    not C-contiguous uint8.

    L_out / rows_out: pad columns/rows up to these sizes with the invalid
    code directly in the packed output — callers that need a padded
    matrix (pipeline row/length bucketing) skip materializing the padded
    uint8 buffer entirely (~1 B/base saved in host passes).

    Returns (packed, invalid, real_has_invalid): the flag is True iff any
    IN-BOUNDS code was >= 4 — when False, the caller can skip the mask
    transfer and rebuild validity from (rows, L) bounds on device."""
    lib = _load()
    if lib is None:
        return None
    if codes.dtype != np.uint8 or not codes.flags.c_contiguous:
        return None
    B, L = codes.shape
    Lo = max(L_out or L, L)
    Bo = max(rows_out or B, B)
    w4 = -(-Lo // 4)
    w8 = -(-Lo // 8)
    packed = np.empty((Bo, w4), dtype=np.uint8)
    invalid = np.empty((Bo, w8), dtype=np.uint8)
    if Bo > B:
        packed[B:] = 0          # (4 & 3) == 0: matches the numpy path
        invalid[B:] = 0xFF
    flag = ctypes.c_int64(0)
    if B:
        nt = threads or min(8, os.cpu_count() or 1)
        got = lib.gt_pack_codes(codes.ctypes.data_as(ctypes.c_void_p), B, L,
                                w4, w8,
                                packed.ctypes.data_as(ctypes.c_void_p),
                                invalid.ctypes.data_as(ctypes.c_void_p),
                                ctypes.byref(flag), nt)
        if got != B:
            return None
    return packed, invalid, bool(flag.value)


def count_fastx_records(path: str) -> int:
    """Record count of a FASTA/FASTQ file (native scan when available)."""
    buf, n = _map_file(path)
    lib = _load()
    if lib is None:
        data = bytes(buf) if not isinstance(buf, bytes) else buf
        return _parse_python(data, None).shape[0]
    nrec = ctypes.c_int64()
    maxlen = ctypes.c_int64()
    rc = lib.gt_scan(_as_cptr(buf), n, ctypes.byref(nrec),
                     ctypes.byref(maxlen))
    if rc < 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, f'parse error {rc}')}")
    return int(nrec.value)


def parse_fastx_codes(path: str, length: int | None = None,
                      threads: int | None = None,
                      record_range: tuple[int, int] | None = None
                      ) -> np.ndarray:
    """FASTA/FASTQ file -> uint8 code matrix [records, L] (pad/invalid=4).

    Uses the C++ parser when available (mmap'd input, record-boundary
    index, multi-threaded decode); Python fallback otherwise. `length`
    pins L (longer sequences truncated); default = max record length
    over the WHOLE file (so range reads from different processes agree).

    record_range: half-open [lo, hi) record slice — only those records
    are decoded and returned (multi-host shard ingest: each process
    decodes 1/P of the file instead of parsing everything and keeping
    1/P). The boundary scan still touches the whole file (sequential,
    ~GB/s); the decode + matrix are range-sized.
    """
    buf, n = _map_file(path)
    lib = _load()
    if lib is None:
        data = bytes(buf) if not isinstance(buf, bytes) else buf
        full = _parse_python(data, length)
        if record_range is not None:
            lo, hi = record_range
            return full[max(0, lo) : max(0, hi)]
        return full
    cbuf = _as_cptr(buf)
    nrec = ctypes.c_int64()
    maxlen = ctypes.c_int64()
    rc = lib.gt_scan(cbuf, n, ctypes.byref(nrec), ctypes.byref(maxlen))
    if rc < 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, f'parse error {rc}')}")
    rows = nrec.value
    L = length if length is not None else int(maxlen.value)
    lo, hi = 0, rows
    if record_range is not None:
        lo = min(max(0, record_range[0]), rows)
        hi = min(max(lo, record_range[1]), rows)
    out = np.empty((hi - lo, max(L, 1)), dtype=np.int8)
    if hi > lo:
        offsets = np.empty((rows,), dtype=np.int64)
        got = lib.gt_index(cbuf, n, offsets.ctypes.data_as(ctypes.c_void_p),
                           rows)
        if got < 0:
            raise ValueError(f"{path}: {_ERRORS.get(got, f'parse error {got}')}")
        assert got == rows, "scan/index record count mismatch"
        nt = threads or min(8, os.cpu_count() or 1)
        sub = np.ascontiguousarray(offsets[lo:hi])
        got = lib.gt_parse_mt(cbuf, n,
                              sub.ctypes.data_as(ctypes.c_void_p), hi - lo,
                              out.ctypes.data_as(ctypes.c_void_p),
                              out.shape[1], nt)
        if got < 0:
            raise ValueError(f"{path}: {_ERRORS.get(got, f'parse error {got}')}")
    return out.view(np.uint8)[:, :L] if L else out.view(np.uint8)
