"""Set intersection of string collections — ``sz_sequence_intersect``.

The reference builds a seeded power-of-2 open-addressing hash table with a
bounded collision budget (reference ``include/stringzilla/intersect.h:33-96``,
``README.md:909-913``). Data-dependent probing serializes on a data-parallel device,
so the design here is a **sort-merge join on hash keys**:

1. every *distinct* string of both collections gets a 64-bit seeded
   StringZilla hash via the batched pipeline (``ops.hash.hash_batch`` /
   the device kernel — seeding defends against adversarial inputs exactly
   like the reference's seeded table);
2. the two key arrays are sorted on device as two u32 lanes per key
   (``jax.lax.sort`` with ``num_keys=2`` — x64 is disabled, so a single
   u64 operand would silently truncate) and merged with a vectorized
   ``searchsorted`` over the *full* equal-key run;
3. hash-equal pairs are verified byte-exact host-side (collisions at 64 bits
   are ~0, but exactness is part of the contract).

Returns the same shape of answer as the C ABI: parallel index arrays into the
first and second sequence (first occurrence of each distinct matching string).
"""

from __future__ import annotations

import numpy as np

from .hash import hash_batch

__all__ = ["intersect"]

_DEVICE_MIN_ITEMS = 1 << 15


def _distinct(items: list[bytes]):
    """(strings, first_index i64[k]) over distinct strings, order-preserving."""
    seen: dict[bytes, int] = {}
    for i, s in enumerate(items):
        if s not in seen:
            seen[s] = i
    strings = list(seen.keys())
    idx = np.fromiter(seen.values(), dtype=np.int64, count=len(seen))
    return strings, idx


def _device_argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Argsort of u64 keys on device as (hi, lo) u32 lanes — JAX with x64
    disabled cannot hold u64 values, so the key is split, never truncated."""
    import jax
    import jax.numpy as jnp

    hi = jnp.asarray((keys >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    iota = jnp.arange(keys.shape[0], dtype=jnp.int32)
    out = jax.lax.sort((hi, lo, iota), dimension=0, is_stable=True, num_keys=2)
    return np.asarray(out[-1]).astype(np.int64)


def _sorted_match(a_keys: np.ndarray, b_keys: np.ndarray):
    """All position pairs (ia, ib) with a_keys[ia] == b_keys[ib]; every
    element of an equal-key run in b is paired (hash collisions between
    distinct strings must all be probed — the exact-verify step downstream
    picks the true matches)."""
    if min(len(a_keys), len(b_keys)) >= _DEVICE_MIN_ITEMS:
        order_a = _device_argsort_u64(a_keys)
        order_b = _device_argsort_u64(b_keys)
    else:
        order_a = np.argsort(a_keys, kind="stable")
        order_b = np.argsort(b_keys, kind="stable")
    sa, sb = a_keys[order_a], b_keys[order_b]
    lo = np.searchsorted(sb, sa, side="left")
    hi = np.searchsorted(sb, sa, side="right")
    runs = hi - lo  # 0 for misses; >1 only under 64-bit collisions
    ia = np.repeat(np.arange(len(sa), dtype=np.int64), runs)
    if len(ia) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # positions within each run: iota minus the run's start offset
    starts = np.repeat(np.cumsum(runs) - runs, runs)
    ib_sorted = np.repeat(lo, runs) + (np.arange(len(ia)) - starts)
    return order_a[ia], order_b[ib_sorted]


def intersect(first, second, seed: int = 0):
    """Indices of distinct common strings: ``(first_idx i64[k], second_idx
    i64[k])`` (C ABI ``sz_sequence_intersect``, reference ``intersect.h:86``).
    Accepts lists of bytes/str, ``Tape``, or ``Strs``."""

    def as_list(x):
        if hasattr(x, "to_list"):
            return [bytes(b) for b in x.to_list()]
        return [s.encode() if isinstance(s, str) else bytes(s) for s in x]

    a_items, b_items = as_list(first), as_list(second)
    a_strs, a_idx = _distinct(a_items)
    b_strs, b_idx = _distinct(b_items)
    if not a_strs or not b_strs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    hasher = hash_batch
    if len(a_strs) + len(b_strs) >= _DEVICE_MIN_ITEMS:
        from ..utils import platform

        if platform.backend() == "gpu":
            from .hash_device import hash_batch_device

            hasher = hash_batch_device
    a_hash = hasher(a_strs, seed)
    b_hash = hasher(b_strs, seed)
    ia, ib = _sorted_match(a_hash, b_hash)
    # Exact verification kills 64-bit collisions (and keeps adversarial
    # inputs correct, like the reference's bounded-budget rehash).
    keep = [k for k in range(len(ia)) if a_strs[ia[k]] == b_strs[ib[k]]]
    out_a = a_idx[ia[keep]] if keep else np.zeros(0, np.int64)
    out_b = b_idx[ib[keep]] if keep else np.zeros(0, np.int64)
    order = np.argsort(out_a, kind="stable")
    return out_a[order], out_b[order]
