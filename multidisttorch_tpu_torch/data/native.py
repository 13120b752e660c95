"""ctypes binding of the native gatherer (``data/csrc/fastloader.cpp``).

Counterpart of ``multidisttorch_tpu/data/native.py``, with the same API:
:class:`NativeBatchGatherer` gathers the rows of a caller's permutation on a
C++ thread, without the GIL, into a ring of buffers ahead of the consumer;
:class:`StackedBatchGatherer` runs it over K lanes' interleaved round
permutation. The permutation comes from numpy, so the rows are the numpy
gather's, byte for byte.

The library is built from the port's own copy of the source by
``ops/_build.py`` into ``build/``, at first use, never at import. Where it
cannot be built or loaded, :func:`available` is False (with one warning)
and the iterators gather with numpy.

One addition, the torch idiom for the same function: ``fl_next_batch``
copies a batch into a caller's buffer, so :meth:`NativeBatchGatherer.next_batch`
and :meth:`StackedBatchGatherer.next_stacked` take ``out=``, for example a
slice of a pinned staging tensor: a whole chunk then lands in pinned host
memory with no stacking pass and no separate pin copy.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from typing import Optional

import numpy as np
import torch

from multidisttorch_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_failure: Optional[str] = None


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _failure
    with _lib_lock:
        if _lib is not None or _failure is not None:
            return _lib
        try:
            lib = _build.load("fastloader")
        except (RuntimeError, OSError) as e:
            _failure = repr(e)
            warnings.warn(f"native gatherer unavailable, the data feed gathers with numpy: {_failure}")
            return None
        lib.fl_create.restype = ctypes.c_void_p
        lib.fl_create.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.fl_start_epoch.restype = ctypes.c_int64
        lib.fl_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.fl_next_batch.restype = ctypes.c_int64
        lib.fl_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.fl_destroy.restype = None
        lib.fl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the gatherer builds and loads here (built at the first
    call)."""
    return _load_library() is not None


def require() -> None:
    """Raise unless the gatherer builds and loads here."""
    if not available():
        raise RuntimeError(f"native gatherer unavailable: {_failure}")


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32}


def _out_ptr(buf, dtype: np.dtype, count: int, what: str) -> int:
    """The address of a caller's output buffer, after checking that it is a
    writable, C-contiguous host buffer of ``count`` elements of ``dtype``."""
    if isinstance(buf, torch.Tensor):
        ok = (buf.device.type == "cpu" and buf.dtype == _TORCH_DTYPES[dtype] and buf.is_contiguous()
              and buf.numel() == count)
        addr = buf.data_ptr()
    elif isinstance(buf, np.ndarray):
        ok = buf.dtype == dtype and buf.flags.c_contiguous and buf.flags.writeable and buf.size == count
        addr = buf.ctypes.data
    else:
        ok = False
    if not ok:
        raise ValueError(f"{what} must be a C-contiguous host numpy array or tensor of {count} {dtype}")
    return addr


class NativeBatchGatherer:
    """Background-threaded batch gather over a host-resident dataset.

    Usage::

        g = NativeBatchGatherer(images, labels)
        n_batches = g.start_epoch(perm, batch_size)
        for _ in range(n_batches):
            imgs, labels = g.next_batch()
        g.close()
    """

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray] = None):
        require()
        self._lib = lib = _lib
        # Contiguous float32/int32 arrays for the library to borrow (no copy
        # when they are so already); kept alive as long as the handle.
        self._images = np.ascontiguousarray(images, dtype=np.float32)
        self._labels = None if labels is None else np.ascontiguousarray(labels, dtype=np.int32)
        self._dim = self._images.shape[1]
        self._batch_size = 0
        self._handle = lib.fl_create(
            self._images.ctypes.data, self._images.shape[0], self._dim,
            None if self._labels is None else self._labels.ctypes.data,
        )
        if not self._handle:
            raise RuntimeError("fl_create failed")

    def start_epoch(self, perm: np.ndarray, batch_size: int) -> int:
        """Begin prefetching an epoch over ``perm``; returns the number of
        batches (the ragged tail is dropped)."""
        self._perm = np.ascontiguousarray(perm, dtype=np.int64)  # kept alive
        self._batch_size = int(batch_size)
        n = self._lib.fl_start_epoch(self._handle, self._perm.ctypes.data, self._perm.shape[0], self._batch_size)
        if n < 0:
            raise ValueError("fl_start_epoch rejected arguments")
        return int(n)

    def next_batch(self, out=None, out_labels=None) -> tuple:
        """The next ``(images (B, D) f32, labels (B,) int32 or None)``,
        waiting for the gather thread. Given ``out`` (and ``out_labels``),
        the rows are copied into it and it is returned. Raises
        ``StopIteration`` at the epoch's end."""
        count = self._batch_size * self._dim
        if out is None:
            out = np.empty((self._batch_size, self._dim), np.float32)
        ptr = _out_ptr(out, np.dtype(np.float32), count, "out")
        lptr = None
        if self._labels is not None:
            if out_labels is None:
                out_labels = np.empty((self._batch_size,), np.int32)
            lptr = _out_ptr(out_labels, np.dtype(np.int32), self._batch_size, "out_labels")
        rows = self._lib.fl_next_batch(self._handle, ptr, lptr)
        if rows < 0:
            raise RuntimeError("fl_next_batch failed (invalid handle/buffer)")
        if rows == 0:
            raise StopIteration
        return out, out_labels

    def close(self) -> None:
        """Stop and join the gather thread and free the library's state."""
        if getattr(self, "_handle", None):
            self._lib.fl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class StackedBatchGatherer:
    """K-lane stacked gather on top of :class:`NativeBatchGatherer`: the
    flat gatherer run over an interleaved permutation (lane 0's batch ``b``
    rows, lane 1's, ...) with ``batch_size = K*B``, so the C++ thread
    assembles a whole ``(K, B, D)`` stacked step per call. Lanes may sit at
    different (seed, epoch) permutations, as after a refill."""

    def __init__(self, images: np.ndarray):
        self._flat = NativeBatchGatherer(images)
        self._k = 0
        self._batch = 0

    def start_round(self, perms: np.ndarray, batch_size: int) -> int:
        """Begin prefetching one lockstep round. ``perms`` is ``(K, N)``,
        each lane's whole epoch permutation, and every lane takes
        ``batch_size`` rows per stacked step. Returns the number of stacked
        steps (``N // batch_size``)."""
        perms = np.asarray(perms)
        if perms.ndim != 2:
            raise ValueError(f"perms must be (K, N), got {perms.shape}")
        k, n = perms.shape
        nb = n // batch_size
        # (K, nb, B) -> (nb, K, B): step-major interleave, dropping each
        # lane's incomplete tail (the train path's drop-tail contract).
        interleaved = perms[:, : nb * batch_size].reshape(k, nb, batch_size).transpose(1, 0, 2).reshape(-1)
        self._k, self._batch = k, batch_size
        got = self._flat.start_epoch(interleaved, k * batch_size)
        if got != nb:
            raise RuntimeError(f"stacked round sized {got} != expected {nb}")
        return nb

    def next_stacked(self, out=None):
        """One ``(K, B, D)`` stacked batch, prefetched off-thread; given
        ``out`` (``K*B*D`` contiguous float32), written into it and
        returned."""
        rows, _ = self._flat.next_batch(out)
        return rows if out is not None else rows.reshape(self._k, self._batch, -1)

    def close(self) -> None:
        self._flat.close()
