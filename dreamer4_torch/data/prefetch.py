"""Native-threaded batch assembly: the data plane's hot path (a copy of
`dreamer4_tpu/data/prefetch.py`, building its own copy of the C++ source).

The reference gets native data loading from torch's DataLoader worker
processes (`trainers.py:649-653` wraps datasets in DataLoaders); here the
equivalent is a C++ worker pool (`native/prefetch.cpp`) driven through
ctypes. Batch assembly for step N+1 (memmap page-in + memcpy + uint8->float
conversion + zero-padding) runs fully off the GIL and overlaps the device
execution of step N, double-buffered.

The library is built with `g++` at first use into `dreamer4_torch/build/`,
named by a hash of the source and the compiler flags, and loaded from there
when it exists; nothing is built when the module is imported.

Public surface:
  CopyEngine           — raw handle over the worker pool (submit/wait)
  PrefetchSampler      — iterator of replay-buffer batches, assembled ahead
  available()          — whether the native library compiled/loaded

Falls back to synchronous numpy assembly when no C++ toolchain exists —
identical batches, no overlap.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
NATIVE_SRC = PACKAGE_DIR / 'native' / 'prefetch.cpp'
BUILD_DIR = PACKAGE_DIR / 'build'
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-pthread', '-std=c++17')

_lib = None
_lib_err: str | None = None
_lib_lock = threading.Lock()


class _PfDesc(ctypes.Structure):
    _fields_ = [
        ('op', ctypes.c_int64),
        ('src', ctypes.c_void_p),
        ('dst', ctypes.c_void_p),
        ('nbytes', ctypes.c_int64),
    ]


OP_MEMCPY = 0
OP_U8_TO_F32 = 1   # nbytes = element count; scales by 1/255
OP_MEMSET0 = 2


def library_path() -> Path:
    h = hashlib.sha256(NATIVE_SRC.read_bytes())
    h.update('\0'.join(GXX_FLAGS).encode())
    return BUILD_DIR / f'libdreamer4_prefetch_{h.hexdigest()[:16]}.so'


def build_library() -> Path:
    """Compile `native/prefetch.cpp` unless its library exists; returns
    the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private file, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(['g++', *GXX_FLAGS, '-o', tmp, str(NATIVE_SRC)],
                              capture_output=True, text=True, timeout=120, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed for {NATIVE_SRC.name}:\n{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load_library():
    global _lib, _lib_err
    with _lib_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build_library()))
            lib.pf_create.argtypes = [ctypes.c_int]
            lib.pf_create.restype = ctypes.c_void_p
            lib.pf_submit.argtypes = [ctypes.c_void_p, ctypes.POINTER(_PfDesc),
                                      ctypes.c_int64]
            lib.pf_submit.restype = ctypes.c_int64
            lib.pf_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.pf_wait.restype = ctypes.c_int
            lib.pf_destroy.argtypes = [ctypes.c_void_p]
            lib.pf_destroy.restype = None
            _lib = lib
        except (OSError, subprocess.SubprocessError, RuntimeError) as e:
            _lib_err = str(e)   # no toolchain or no loadable library: the fallback
        return _lib


def available() -> bool:
    return _load_library() is not None


def load_error() -> str | None:
    """Why the native library could not be built or loaded, if so."""
    _load_library()
    return _lib_err


class CopyEngine:
    """Worker pool executing flat copy/convert/zero descriptor lists.

    descs: list of (op, src_addr, dst_addr, nbytes). Addresses are raw
    pointers (`arr.ctypes.data + byte_offset`); the caller owns lifetime of
    the underlying arrays until `wait` returns.
    """

    def __init__(self, num_workers: int | None = None):
        self._lib = _load_library()
        n = num_workers or min(8, os.cpu_count() or 1)
        self._handle = self._lib.pf_create(n) if self._lib else None

    def submit(self, descs) -> int:
        if self._handle is None:
            for op, src, dst, nbytes in descs:  # synchronous fallback
                _execute_py(op, src, dst, nbytes)
            return -1
        arr = (_PfDesc * len(descs))()
        for i, (op, src, dst, nbytes) in enumerate(descs):
            arr[i].op, arr[i].src, arr[i].dst, arr[i].nbytes = op, src, dst, nbytes
        return int(self._lib.pf_submit(self._handle, arr, len(descs)))

    def wait(self, ticket: int):
        if self._handle is not None and ticket >= 0:
            self._lib.pf_wait(self._handle, ticket)

    def close(self):
        if self._handle is not None:
            self._lib.pf_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _execute_py(op, src, dst, nbytes):
    if op == OP_MEMSET0:
        ctypes.memset(dst, 0, nbytes)
    elif op == OP_MEMCPY:
        ctypes.memmove(dst, src, nbytes)
    elif op == OP_U8_TO_F32:
        n = nbytes
        s = np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(src))
        d = np.ctypeslib.as_array((ctypes.c_float * n).from_address(dst))
        np.multiply(s, np.float32(1 / 255), out=d, casting='unsafe')


def _addr(arr: np.ndarray, *idx) -> int:
    off = sum(i * s for i, s in zip(idx, arr.strides))
    return arr.ctypes.data + off


class PrefetchSampler:
    """Double-buffered replay-buffer batch stream.

    Each produced batch is identical to `buffer.sample_batch(rng, ...)` given
    the same rng draws, but is assembled by the native pool while the caller
    consumes the previous batch. `convert_uint8_fields` maps uint8 fields to
    [0,1] float32 on the fly (the usual image normalization, done in C++
    instead of numpy).

    The returned dict is only valid until the next `__next__` call (buffers
    are reused) — copy it to the device (`torch.as_tensor(..., device=...)`)
    before asking for the next batch.
    """

    def __init__(self, buffer, batch_size: int, seq_len: int, *,
                 rng: np.random.Generator | None = None,
                 convert_uint8_fields: tuple = (),
                 num_workers: int | None = None):
        self.buffer = buffer
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rng = rng or np.random.default_rng(0)
        self.convert = set(convert_uint8_fields)
        self.engine = CopyEngine(num_workers)

        def alloc():
            out = {}
            for k, (dtype, shape) in buffer.fields.items():
                odt = np.float32 if k in self.convert else dtype
                out[k] = np.zeros((batch_size, seq_len, *shape), odt)
            out['lens'] = np.zeros((batch_size,), np.int64)
            for k, (dtype, shape) in buffer.meta_fields.items():
                out[k] = np.zeros((batch_size, *shape), dtype)
            return out

        self._bufs = [alloc(), alloc()]
        self._ticket = None
        self._slot = 0
        self._pending_plan = None

    # ------------------------------------------------------------ planning

    def _plan(self):
        n = self.buffer.num_episodes
        assert n > 0, 'replay buffer is empty'
        idxs = self.rng.integers(0, n, size=self.batch_size)
        lengths = self.buffer._lengths[idxs]
        takes = np.minimum(lengths, self.seq_len)
        starts = np.array([
            int(self.rng.integers(0, int(l) - int(t) + 1)) if l > t else 0
            for l, t in zip(lengths, takes)])
        return idxs, starts, takes

    def _descriptors(self, plan, out):
        idxs, starts, takes = plan
        descs = []
        for k, (dtype, shape) in self.buffer.fields.items():
            src = self.buffer._data[k]
            dst = out[k]
            row = int(np.prod(shape, dtype=np.int64)) if shape else 1
            item = src.dtype.itemsize
            for i in range(self.batch_size):
                take = int(takes[i])
                if take > 0:
                    s_addr = _addr(src, int(idxs[i]), int(starts[i]))
                    d_addr = _addr(dst, i)
                    if k in self.convert:
                        descs.append((OP_U8_TO_F32, s_addr, d_addr, take * row))
                    else:
                        descs.append((OP_MEMCPY, s_addr, d_addr, take * row * item))
                pad = self.seq_len - take
                if pad > 0:
                    descs.append((OP_MEMSET0, 0,
                                  _addr(dst, i, take), pad * row * dst.dtype.itemsize))
        for k in self.buffer.meta_fields:
            src = self.buffer._meta[k]
            dst = out[k]
            row = dst.dtype.itemsize * (int(np.prod(dst.shape[1:])) if dst.ndim > 1 else 1)
            for i in range(self.batch_size):
                descs.append((OP_MEMCPY, _addr(src, int(idxs[i])), _addr(dst, i), row))
        return descs

    def _kick(self):
        plan = self._plan()
        out = self._bufs[self._slot]
        out['lens'][:] = plan[2]
        self._ticket = self.engine.submit(self._descriptors(plan, out))

    # ------------------------------------------------------------ iterator

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._ticket is None:
            self._kick()
        self.engine.wait(self._ticket)
        ready = self._bufs[self._slot]
        self._slot ^= 1
        self._kick()
        return ready

    def close(self):
        if self._ticket is not None:
            self.engine.wait(self._ticket)
        self.engine.close()
