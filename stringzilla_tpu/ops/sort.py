"""Device argsort of string collections — the ``sz_sequence_argsort`` analog.

The reference exports pointer-sized "pgrams" (first 8 bytes) to a contiguous
buffer, runs a 3-way-partition QuickSort on them, and recurses into equal runs
at deeper offsets (reference ``include/stringzilla/sort.h:87,141``,
``sort/serial.h:25-105``). Recursion into data-dependent equal runs is hostile
to XLA, so the design here sorts ONCE, lexicographically, on the full key
ladder:

* every string's bytes become big-endian ``uint32`` key words (zero-padded —
  shorter strings order before their extensions) plus a length tiebreak word;
  the export runs in the native host runtime (``native/tapecraft.cpp``
  ``tc_pgram_keys``) with a numpy fallback;
* one ``jax.lax.sort`` call over ``(key0, key1, ..., len, iota)`` — XLA's
  multi-operand sort on device; the trailing iota both makes the sort stable
  and returns the permutation.

``reverse=True`` inverts the key bytes (``0xFF - b``) before sorting, which
yields descending order while keeping ties stable — matching the reference's
``reverse`` flag (``sort.h:24-26``). ``top_count`` returns only the first K
indices (``sort.h:24``, partial mode). ``uncased`` folds ASCII case during
key export (``sz_sequence_argsort_uncased``, ``sort.h:114``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import native

__all__ = ["argsort_strings", "argsort_tape", "argsort_bounds", "pack_pgram_keys"]

_DEVICE_MIN_ITEMS = 1 << 14  # below this, host lexsort wins on latency


def pack_pgram_keys(items: list[bytes], reverse: bool = False,
                    uncased: bool = False) -> np.ndarray:
    """Dense key matrix ``uint32[n, ceil(maxlen/4) + 1]`` (numpy reference
    packer; the native tier is ``tc_pgram_keys``)."""
    n = len(items)
    maxlen = max((len(s) for s in items), default=0)
    width = max(-(-maxlen // 8) * 8, 8)
    dense = np.zeros((n, width), dtype=np.uint8)
    for i, s in enumerate(items):
        dense[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    if uncased:
        is_upper = (dense >= 65) & (dense <= 90)
        dense = np.where(is_upper, dense + 32, dense)
    if reverse:
        dense = 255 - dense
    keys = dense.reshape(n, -1, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32
    )
    lens = np.array([len(s) for s in items], dtype=np.uint32)
    if reverse:
        lens = ~lens
    return np.concatenate([keys, lens[:, None]], axis=1)


@partial(jax.jit, static_argnames=("num_keys",))
def _device_argsort(keys: jnp.ndarray, num_keys: int) -> jnp.ndarray:
    n = keys.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    operands = tuple(keys[:, c] for c in range(num_keys)) + (iota,)
    out = jax.lax.sort(operands, dimension=0, is_stable=True, num_keys=num_keys)
    return out[-1]


def _argsort_keys(keys: np.ndarray, top_count: int | None,
                  prefer_device: bool = False) -> np.ndarray:
    """Sort the key matrix. Host ``np.lexsort`` is the one-shot default —
    ``lax.sort`` over a large key matrix takes long to COMPILE, so the
    device tier only pays off for repeated same-shape batches (set ``prefer_device`` from device-resident
    pipelines; the key matrix is padded to a dyadic row count so compiled
    specializations amortize across sizes)."""
    n = keys.shape[0]
    if top_count is not None and 0 < top_count < n // 4:
        # Partial-sort pruning (reference ``sz_sequence_argsort_top_k``,
        # sort.h:24-26): O(n) argpartition on the leading key word selects
        # the candidate set — every row whose first word ties the k-th
        # smallest stays in, so the subsequent full sort of the (typically
        # ~k-sized) candidate set is exact; degenerate all-ties corpora
        # fall through to the full sort below.
        c0 = keys[:, 0]
        thresh = c0[np.argpartition(c0, top_count - 1)[top_count - 1]]
        cand = np.flatnonzero(c0 <= thresh)
        if cand.size < n:
            sub = _argsort_keys(keys[cand], None, prefer_device=prefer_device)
            return cand[sub][:top_count].astype(np.int64)
    if not prefer_device or n < _DEVICE_MIN_ITEMS:
        order = native.argsort_keys(keys)
        if order is None:  # no native library → numpy lexsort
            order = np.lexsort(
                tuple(keys[:, c] for c in reversed(range(keys.shape[1]))))
    else:
        m = 1 << (n - 1).bit_length()
        if m != n:
            pad = np.full((m - n, keys.shape[1]), 0xFFFFFFFF, dtype=keys.dtype)
            keys = np.concatenate([keys, pad], axis=0)
        order = np.asarray(_device_argsort(jnp.asarray(keys), keys.shape[1]))
        order = order[order < n]
    order = order.astype(np.int64)
    return order[:top_count] if top_count is not None else order


def argsort_bounds(data: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                   reverse: bool = False, top_count: int | None = None,
                   uncased: bool = False,
                   prefer_device: bool = False) -> np.ndarray:
    """Argsort of string views ``data[starts[i]:ends[i]]`` — zero-copy entry
    used by ``Strs.order``. ``uncased`` applies FULL Unicode case folding
    when the buffer contains non-ASCII bytes (``sz_sequence_argsort_uncased``,
    reference ``sort.h:18-22,114``); pure-ASCII corpora keep the cheap
    in-register A-Z fold."""
    if len(starts) == 0:
        return np.zeros(0, dtype=np.int64)
    data = np.asarray(data)
    maxlen = int((np.asarray(ends) - np.asarray(starts)).max())
    if uncased and bool((data >= 0x80).any()):
        # folded bytes can expand up to 3x the raw length
        words = max(-(-(3 * maxlen) // 4), 2)
        from .utf8 import _fold_tables

        tabs = _fold_tables()
        keys = (native.pgram_keys_unicode(data, starts, ends, words, reverse,
                                          *tabs)
                if tabs is not None else None)
        if keys is None:
            from .utf8 import utf8_fold

            items = [utf8_fold(bytes(data[int(s):int(e)]))
                     for s, e in zip(starts, ends)]
            keys = pack_pgram_keys(items, reverse=reverse, uncased=False)
        return _argsort_keys(keys, top_count, prefer_device=prefer_device)
    words = max(-(-maxlen // 4), 2)
    keys = native.pgram_keys(data, starts, ends, words,
                             uncased=uncased, reverse=reverse)
    if keys is None:
        items = [bytes(data[int(s) : int(e)]) for s, e in zip(starts, ends)]
        keys = pack_pgram_keys(items, reverse=reverse, uncased=uncased)
    return _argsort_keys(keys, top_count, prefer_device=prefer_device)


def argsort_strings(items: list[bytes], reverse: bool = False,
                    top_count: int | None = None,
                    uncased: bool = False,
                    prefer_device: bool = False) -> np.ndarray:
    """Stable argsort permutation of a list of byte strings."""
    if len(items) == 0:
        return np.zeros(0, dtype=np.int64)
    lens = np.fromiter(map(len, items), dtype=np.int64, count=len(items))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(b"".join(items), dtype=np.uint8)
    return argsort_bounds(data, offsets[:-1], offsets[1:], reverse=reverse,
                          top_count=top_count, uncased=uncased,
                          prefer_device=prefer_device)


def argsort_tape(tape, **kwargs) -> np.ndarray:
    """Argsort of a ``Tape`` (the ``szs``-style tape container)."""
    return argsort_bounds(np.asarray(tape.data), tape.offsets[:-1],
                          tape.offsets[1:], **kwargs)
