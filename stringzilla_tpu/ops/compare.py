"""Compare domain — equality & 3-way lexicographic order, single and batch.

The reference's ``compare`` domain (``sz_equal`` reference ``compare.h:53``,
``sz_order`` ``compare.h:88``) is bounded memcmp with per-ISA tiers. On the
device the interesting shape is the *batch* form: order/equality verdicts for whole
collections at once, computed from the same big-endian key words the sorter
exports (``native/tapecraft.cpp tc_pgram_keys``) — a comparison is just a
lexicographic compare of key vectors, fully vectorized.
"""

from __future__ import annotations

import numpy as np

from ..utils import native

__all__ = ["equal", "order", "batch_equal", "batch_order"]


def _as_bytes(x) -> bytes:
    if isinstance(x, str):
        return x.encode("utf-8")
    return bytes(x)


def equal(a, b) -> bool:
    """Bounded equality (``sz_equal``, reference ``compare.h:53``)."""
    return _as_bytes(a) == _as_bytes(b)


def order(a, b) -> int:
    """3-way lexicographic order: -1/0/+1 (``sz_order``, ``compare.h:88``)."""
    a, b = _as_bytes(a), _as_bytes(b)
    return -1 if a < b else (0 if a == b else 1)


def _keys_for(items: list[bytes]) -> np.ndarray:
    lens = np.fromiter(map(len, items), dtype=np.int64, count=len(items))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(b"".join(items), dtype=np.uint8)
    maxlen = int(lens.max()) if len(items) else 0
    words = max(-(-maxlen // 4), 2)
    keys = native.pgram_keys(data, offsets[:-1], offsets[1:], words)
    if keys is None:  # no native library — numpy fallback
        from .sort import pack_pgram_keys

        keys = pack_pgram_keys(items)
    return keys


def batch_equal(first, second) -> np.ndarray:
    """Pairwise ``first[i] == second[i]`` over two equally-long collections."""
    a = [_as_bytes(x) for x in first]
    b = [_as_bytes(x) for x in second]
    if len(a) != len(b):
        raise ValueError("collections must have equal length")
    if not a:
        return np.zeros(0, dtype=bool)
    ka, kb = _keys_for(a), _keys_for(b)
    w = max(ka.shape[1], kb.shape[1])

    def padw(k):
        if k.shape[1] == w:
            return k
        out = np.zeros((k.shape[0], w), dtype=np.uint32)
        out[:, : k.shape[1] - 1] = k[:, :-1]
        out[:, -1] = k[:, -1]  # length tiebreak stays last
        return out

    return (padw(ka) == padw(kb)).all(axis=1)


def batch_order(first, second) -> np.ndarray:
    """Pairwise 3-way order verdicts (-1/0/+1) as ``int8[n]``."""
    a = [_as_bytes(x) for x in first]
    b = [_as_bytes(x) for x in second]
    if len(a) != len(b):
        raise ValueError("collections must have equal length")
    if not a:
        return np.zeros(0, dtype=np.int8)
    ka, kb = _keys_for(a), _keys_for(b)
    w = max(ka.shape[1], kb.shape[1])

    def padw(k):
        out = np.zeros((k.shape[0], w), dtype=np.uint32)
        out[:, : k.shape[1] - 1] = k[:, :-1]
        out[:, -1] = k[:, -1]
        return out

    ka, kb = padw(ka), padw(kb)
    lt = np.zeros(len(a), dtype=bool)
    gt = np.zeros(len(a), dtype=bool)
    undecided = np.ones(len(a), dtype=bool)
    for c in range(w):
        col_lt = undecided & (ka[:, c] < kb[:, c])
        col_gt = undecided & (ka[:, c] > kb[:, c])
        lt |= col_lt
        gt |= col_gt
        undecided &= ~(col_lt | col_gt)
    return (gt.astype(np.int8) - lt.astype(np.int8))
