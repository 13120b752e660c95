"""Side streams that two live users do not share.

``torch.cuda.Stream()`` hands out the streams of PyTorch's pool in turn
(32 a priority level), so the 33rd stream of a process is the first again.
Two users of one stream in one thread only queue behind each other, but the
compile farm (``compile/farm.py``) captures on worker threads while the
driver's thread replays, and work that another thread queues on a stream
under capture lands in that capture's graph. :func:`side_stream` therefore
hands each user (a ``_GraphedChunks``, the stacked feed's copy stream) a
pool stream that no live user holds, and only when every stream of both
pools of its device is held, the least held one; a user that may share
one does its work on it under :func:`stream_lock`, so a capture and
another thread's work never meet on one stream.
"""

from __future__ import annotations

import threading
import weakref
from collections import Counter

import torch

_POOL = 32  # streams per priority level in PyTorch's pool
_GUARD = threading.Lock()
_HELD: Counter = Counter()  # (device index, raw stream) -> live users
_LOCKS: dict = {}


def _key(stream: torch.cuda.Stream) -> tuple:
    return (stream.device_index, stream.cuda_stream)


def _release(key: tuple) -> None:
    with _GUARD:
        _HELD[key] -= 1
        if _HELD[key] <= 0:
            del _HELD[key]


def side_stream(device: torch.device, owner) -> torch.cuda.Stream:
    """A pool stream of ``device`` for ``owner``, held until ``owner`` is
    collected: one no live owner holds if there is one, else the least
    held."""
    with _GUARD:
        best = None
        for priority in (0, -1):
            for _ in range(_POOL):
                s = torch.cuda.Stream(device, priority=priority)
                if best is None or _HELD[_key(s)] < _HELD[_key(best)]:
                    best = s
                if _HELD[_key(best)] == 0:
                    break
            if _HELD[_key(best)] == 0:
                break
        key = _key(best)
        _HELD[key] += 1
        _LOCKS.setdefault(key, threading.RLock())
    weakref.finalize(owner, _release, key)
    return best


def stream_lock(stream: torch.cuda.Stream) -> threading.RLock:
    """The lock of a stream :func:`side_stream` handed out: held around a
    capture on it and around other work queued on it."""
    with _GUARD:
        return _LOCKS.setdefault(_key(stream), threading.RLock())
