"""ctypes binding for the native C++ ring buffer (native/ringbuffer.cpp).

Same sequence/drop semantics as the Python :class:`~fxtpu.runtime.ringbuffer.
RingBuffer`; used for high-rate ingest (>=100 MS/s streaming) where
the Python condition-variable lock dominates.  Falls back cleanly: callers
use :func:`native_available` / :func:`make_ring` and get the Python
implementation when the shared library hasn't been built
(``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from fxtpu.runtime.ringbuffer import BufferClosed, BufferFull, RingBuffer

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libfxring.so"),
    os.path.join(os.path.dirname(__file__), "libfxring.so"),
]

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            lib = ctypes.CDLL(p)
            lib.rb_create.restype = ctypes.c_void_p
            lib.rb_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
            lib.rb_destroy.argtypes = [ctypes.c_void_p]
            lib.rb_size.restype = ctypes.c_int64
            lib.rb_size.argtypes = [ctypes.c_void_p]
            lib.rb_drops.restype = ctypes.c_int64
            lib.rb_drops.argtypes = [ctypes.c_void_p]
            lib.rb_total_put.restype = ctypes.c_int64
            lib.rb_total_put.argtypes = [ctypes.c_void_p]
            lib.rb_close.argtypes = [ctypes.c_void_p]
            lib.rb_closed.restype = ctypes.c_int
            lib.rb_closed.argtypes = [ctypes.c_void_p]
            lib.rb_put.restype = ctypes.c_int
            lib.rb_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_double]
            lib.rb_get.restype = ctypes.c_int
            lib.rb_get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_double]
            lib.rb_peek.restype = ctypes.c_int
            lib.rb_peek.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_double]
            lib.rb_release.argtypes = [ctypes.c_void_p]
            if hasattr(lib, "rb_reserve"):
                lib.rb_reserve.restype = ctypes.c_int
                lib.rb_reserve.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_void_p),
                                           ctypes.c_double]
                lib.rb_commit.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            if hasattr(lib, "fx_quant_c64_i8"):   # older .so: ring only
                P, I64, F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
                lib.fx_quant_c64_i8.argtypes = [P, P, I64, F32]
                lib.fx_split_i8.argtypes = [P, P, P, I64]
                lib.fx_split_c64.argtypes = [P, P, P, I64]
            _lib = lib
            return lib
    return None


def _dataplane():
    lib = _load()
    return lib if lib is not None and hasattr(lib, "fx_quant_c64_i8") \
        else None


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# Host data-plane kernels (native/dataplane.cpp): single-pass SIMD loops for
# the CPU stages between the SDR byte stream and jax.device_put.  Each
# wrapper takes/returns the same numpy shapes as the pure-numpy expression it
# replaces and falls back to it when the library is missing or the input
# layout disqualifies the flat native loop.

def quantize_c64(block: np.ndarray, quant_step: float,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """complex64 ``[..., n]`` -> int8 ``[..., n, 2]``, round(x/step)
    clipped to [-127, 127] (the QuantizedSource._quantize contract).
    Native: one pass at ~2 GS/s vs numpy's ~0.24 GS/s ufunc chain.
    ``out`` (int8, ``block.shape + (2,)``, contiguous) lets the caller
    quantize straight into a ring slot (zero-copy producer path)."""
    lib = _dataplane()
    if (lib is not None and block.dtype == np.complex64
            and block.flags.c_contiguous):
        if out is None:
            out = np.empty((*block.shape, 2), np.int8)
        else:
            assert out.dtype == np.int8 and out.flags.c_contiguous \
                and out.shape == (*block.shape, 2), (out.shape, block.shape)
        lib.fx_quant_c64_i8(_ptr(block), _ptr(out), block.size,
                            1.0 / float(quant_step))
        return out
    q = out if out is not None \
        else np.empty((*block.shape, 2), dtype=np.int8)
    inv = 1.0 / quant_step
    np.clip(np.rint(block.real * inv), -127, 127, out=q[..., 0],
            casting="unsafe")
    np.clip(np.rint(block.imag * inv), -127, 127, out=q[..., 1],
            casting="unsafe")
    return q


def split_planes_i8(block: np.ndarray):
    """int8 ``[..., n, 2]`` interleaved -> (re, im) contiguous int8
    ``[..., n]`` planes."""
    lib = _dataplane()
    if lib is not None and block.dtype == np.int8 \
            and block.flags.c_contiguous:
        shape = block.shape[:-1]
        re = np.empty(shape, np.int8)
        im = np.empty(shape, np.int8)
        lib.fx_split_i8(_ptr(block), _ptr(re), _ptr(im), re.size)
        return re, im
    return (np.ascontiguousarray(block[..., 0]),
            np.ascontiguousarray(block[..., 1]))


def split_planes_c64(block: np.ndarray):
    """complex64 ``[..., n]`` -> (re, im) contiguous f32 planes."""
    lib = _dataplane()
    if lib is not None and block.dtype == np.complex64 \
            and block.flags.c_contiguous:
        re = np.empty(block.shape, np.float32)
        im = np.empty(block.shape, np.float32)
        lib.fx_split_c64(_ptr(block), _ptr(re), _ptr(im), block.size)
        return re, im
    return (np.ascontiguousarray(block.real, dtype=np.float32),
            np.ascontiguousarray(block.imag, dtype=np.float32))


def native_available() -> bool:
    return _load() is not None


class NativeRingBuffer:
    """Drop-in for the Python RingBuffer (put/get/qsize/drops/close) backed
    by the lock-free C++ implementation."""

    def __init__(self, capacity: int, block_shape, dtype=np.complex64,
                 policy: str = "raise"):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native ring buffer not built; run `make -C native`")
        if policy not in ("raise", "drop"):
            raise ValueError(f"native ring supports raise/drop, got {policy}")
        self._lib = lib
        self.capacity = int(capacity)
        self.block_shape = tuple(block_shape)
        self.dtype = np.dtype(dtype)
        self.block_bytes = int(np.prod(self.block_shape)) * self.dtype.itemsize
        self.policy = policy
        self._rb = lib.rb_create(self.capacity, self.block_bytes)
        if not self._rb:
            raise MemoryError("rb_create failed")
        self._next_seq = 0

    # -- RingBuffer-compatible surface ---------------------------------
    def qsize(self) -> int:
        return int(self._lib.rb_size(self._rb))

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.qsize() >= self.capacity

    @property
    def drops(self) -> int:
        return int(self._lib.rb_drops(self._rb))

    @property
    def total_put(self) -> int:
        return int(self._lib.rb_total_put(self._rb))

    @property
    def closed(self) -> bool:
        return bool(self._lib.rb_closed(self._rb))

    def close(self):
        self._lib.rb_close(self._rb)

    def put(self, block: np.ndarray, timeout: Optional[float] = None,
            seq: Optional[int] = None) -> int:
        if seq is None:
            seq = self._next_seq
        block = np.ascontiguousarray(block, dtype=self.dtype)
        # timeout=None waits forever, like the Python RingBuffer (and like
        # get/get_view below) — not 0.0, which would fail on the first
        # full poll
        rc = self._lib.rb_put(
            self._rb, block.ctypes.data_as(ctypes.c_void_p), block.nbytes,
            seq, 1e9 if timeout is None else float(timeout))
        if rc == -2:
            raise BufferClosed("put on closed ring buffer")
        if rc == -1:
            if self.policy == "raise":
                raise BufferFull(
                    f"native ring buffer full for {timeout} s "
                    f"({self.drops} drops so far)")
            return -1
        self._next_seq = seq + 1
        return seq

    @property
    def can_reserve(self) -> bool:
        """True when the loaded .so exports the zero-copy producer API
        (rb_reserve/rb_commit) — the Feeder gates its zero-copy loop on
        this, never on hasattr(ring, 'reserve') (always true here)."""
        return hasattr(self._lib, "rb_reserve")

    def reserve(self, timeout: Optional[float] = None
                ) -> Optional[np.ndarray]:
        """Zero-copy producer slot: the returned view IS ring memory — the
        source's read (or the native quantizer) writes the block directly
        into it, deleting put()'s staging memcpy.  Publish with
        :meth:`commit`; an uncommitted reservation is simply abandoned.
        Same timeout semantics as put() (raise/drop policy, drop counted)."""
        if not self.can_reserve:
            return None
        ptr = ctypes.c_void_p()
        rc = self._lib.rb_reserve(
            self._rb, ctypes.byref(ptr),
            1e9 if timeout is None else float(timeout))
        if rc == -2:
            raise BufferClosed("reserve on closed ring buffer")
        if rc == -1:
            if self.policy == "raise":
                raise BufferFull(
                    f"native ring buffer full for {timeout} s "
                    f"({self.drops} drops so far)")
            return None
        buf = (ctypes.c_char * self.block_bytes).from_address(ptr.value)
        return np.frombuffer(buf, dtype=self.dtype).reshape(self.block_shape)

    def commit(self, seq: Optional[int] = None) -> int:
        if seq is None:
            seq = self._next_seq
        self._lib.rb_commit(self._rb, seq)
        self._next_seq = seq + 1
        return seq

    def get(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[int, np.ndarray]]:
        out = np.empty(self.block_shape, dtype=self.dtype)
        seq = ctypes.c_int64()
        rc = self._lib.rb_get(
            self._rb, out.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(seq), 1e9 if timeout is None else float(timeout))
        if rc != 0:
            return None
        return int(seq.value), out

    def get_view(self, timeout: Optional[float] = None):
        """Zero-copy consumer view; call :meth:`release` when done."""
        ptr = ctypes.c_void_p()
        seq = ctypes.c_int64()
        rc = self._lib.rb_peek(self._rb, ctypes.byref(ptr), ctypes.byref(seq),
                               1e9 if timeout is None else float(timeout))
        if rc != 0:
            return None
        buf = (ctypes.c_char * self.block_bytes).from_address(ptr.value)
        arr = np.frombuffer(buf, dtype=self.dtype).reshape(self.block_shape)
        return int(seq.value), arr

    def release(self):
        self._lib.rb_release(self._rb)

    def __del__(self):
        try:
            if getattr(self, "_rb", None):
                self._lib.rb_destroy(self._rb)
                self._rb = None
        except Exception:
            pass


def make_ring(capacity: int, block_shape, dtype=np.complex64,
              policy: str = "raise", prefer_native: bool = True):
    """Build the fastest available ring buffer implementation."""
    if prefer_native and native_available() and policy in ("raise", "drop"):
        return NativeRingBuffer(capacity, block_shape, dtype, policy)
    return RingBuffer(capacity, block_shape, dtype, policy)
