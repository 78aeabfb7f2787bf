"""ctypes bindings of the native host data plane, ``runtime/host_buffer.cpp``
(the port's own copy of ``nlbac_tpu/runtime_native.py``).

- ``HostReplay``: the host loop's RL replay (``train/host_loop.py``): a
  flat float32 ring with memcpy pushes and xorshift128+ sampling with
  replacement.
- ``NativeTsvWriter``: the ``EpochLogger``'s default ``progress.txt``
  writer (``train/logging.py``), rows byte-identical to the Python
  writer's ``%.6g``.

The C++ source is compiled unchanged with ``g++`` at first use into
``nlbac_tpu_torch/_build/`` (named by the source's hash, so an edited
source is rebuilt); nothing is written under ``runtime/``. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
_SOURCE = _ROOT / "runtime" / "host_buffer.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_lib = None


def build() -> Path:
    """Compile ``runtime/host_buffer.cpp`` (once per source version) and
    return the shared library's path."""
    src = _SOURCE.read_bytes()
    out = _BUILD_DIR / \
        f"libnlbac_host-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH; the native host "
                           f"data plane ({_SOURCE}) cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [cxx, "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-o", tmp, str(_SOURCE)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {_SOURCE} failed "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, u64, vp = ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
    fp = ctypes.POINTER(ctypes.c_float)
    up = ctypes.POINTER(u64)
    dp = ctypes.POINTER(ctypes.c_double)
    signatures = {
        "rb_create": (vp, [i64, i64, u64]),
        "rb_destroy": (None, [vp]),
        "rb_push": (None, [vp, fp]),
        "rb_push_many": (None, [vp, fp, i64]),
        "rb_sample": (None, [vp, i64, i64, fp]),
        "rb_size": (i64, [vp]),
        "rb_total": (i64, [vp]),
        "rb_snapshot": (None, [vp, fp, up]),
        "rb_restore": (None, [vp, fp, up]),
        "tsv_create": (vp, [ctypes.c_char_p]),
        "tsv_destroy": (None, [vp]),
        "tsv_header": (None, [vp, ctypes.c_char_p]),
        "tsv_row": (None, [vp, dp, i64]),
        "tsv_flush": (None, [vp]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u64_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class HostReplay:
    """Ring buffer of flat float32 records in native memory."""

    def __init__(self, capacity: int, record_size: int, seed: int = 0):
        self._lib = _load()
        self.capacity = int(capacity)
        self.record_size = int(record_size)
        self._h = self._lib.rb_create(self.capacity, self.record_size,
                                      int(seed))

    def push(self, record: np.ndarray) -> None:
        rec = np.ascontiguousarray(record, np.float32)
        if rec.size != self.record_size:
            raise ValueError(f"record of {rec.size} floats, the ring holds "
                             f"{self.record_size}")
        self._lib.rb_push(self._h, _float_ptr(rec))

    def push_many(self, records: np.ndarray) -> None:
        recs = np.ascontiguousarray(records, np.float32)
        if recs.ndim != 2 or recs.shape[1] != self.record_size:
            raise ValueError(f"records of shape {recs.shape}, the ring "
                             f"holds (n, {self.record_size})")
        self._lib.rb_push_many(self._h, _float_ptr(recs), recs.shape[0])

    def sample(self, n: int, max_index: int = 0, out=None) -> np.ndarray:
        """``n`` records drawn uniformly with replacement from the first
        ``min(size, max_index or size)``, into ``out`` (a C-contiguous
        float32 (n, record_size) array) when given."""
        if out is None:
            out = np.empty((n, self.record_size), np.float32)
        elif (out.dtype != np.float32 or out.shape != (n, self.record_size)
              or not out.flags.c_contiguous):
            raise ValueError(f"out must be a C-contiguous float32 "
                             f"({n}, {self.record_size}) array")
        self._lib.rb_sample(self._h, n, max_index, _float_ptr(out))
        return out

    @property
    def size(self) -> int:
        return self._lib.rb_size(self._h)

    @property
    def total(self) -> int:
        return self._lib.rb_total(self._h)

    def snapshot(self) -> tuple:
        """``(data, meta)``: the ring's contents and [position, size,
        total, rng_s0, rng_s1] as uint64, which ``restore`` takes back
        (the rows and the sampler's stream)."""
        data = np.empty((self.capacity, self.record_size), np.float32)
        meta = np.empty(5, np.uint64)
        self._lib.rb_snapshot(self._h, _float_ptr(data), _u64_ptr(meta))
        return data, meta

    def restore(self, data: np.ndarray, meta: np.ndarray) -> None:
        """Restore a ``snapshot``. The shapes and the cursor are checked
        before the native call, which copies the whole buffer and trusts
        the cursor: position must lie in [0, capacity), size in [0,
        capacity] and total must be at least size."""
        data = np.ascontiguousarray(data, np.float32)
        if data.shape != (self.capacity, self.record_size):
            raise ValueError(
                f"ring restore shape {data.shape} != ring "
                f"({self.capacity}, {self.record_size}) (was the replay "
                "capacity changed since saving?)")
        meta = np.ascontiguousarray(meta, np.uint64)
        if meta.shape != (5,):
            raise ValueError(f"ring restore meta shape {meta.shape} != (5,)")
        position, size, total = (int(v) for v in meta[:3])
        if not (0 <= position < self.capacity and 0 <= size <= self.capacity
                and total >= size):
            raise ValueError(
                f"ring restore cursor (position {position}, size {size}, "
                f"total {total}) does not fit a ring of capacity "
                f"{self.capacity}")
        self._lib.rb_restore(self._h, _float_ptr(data), _u64_ptr(meta))

    def __len__(self) -> int:
        return self.size

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None


class NativeTsvWriter:
    """Buffered native writer of tab-separated ``%.6g`` rows."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.tsv_create(os.fsencode(path))
        # float64, so %.6g formats the same double the Python writer does
        self._buf = np.empty((0,), np.float64)

    def header(self, columns) -> None:
        self._lib.tsv_header(self._h, "\t".join(columns).encode())

    def row(self, values) -> None:
        if self._buf.size != len(values):
            self._buf = np.empty((len(values),), np.float64)
        self._buf[:] = values
        self._lib.tsv_row(
            self._h,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self._buf.size)

    def flush(self) -> None:
        self._lib.tsv_flush(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tsv_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
