"""Exact substring & byteset search — device-resident, XLA-fused.

Re-design of the reference's ``find`` domain (reference
``include/stringzilla/find.h:43-431``): ``sz_find`` / ``sz_rfind`` /
``sz_find_byte`` / ``sz_find_byteset`` and counting.

The reference picks needle-length-tiered kernels (SWAR 2/3/4-byte, Raita
anomaly offsets + BMH skip tables, reference ``find/serial.h:35,449,637``)
because a scalar CPU must *skip* work. An accelerator wants the opposite
shape: dense, branch-free compares over the whole buffer, fused by XLA into
one streaming pass and reduced with ``min``/``max``/``sum``:

* short needles (≤ ``_DENSE_NEEDLE_LIMIT``): ``match[p] = AND_a
  hay[p+a] == needle[a]`` — k shifted compares, fully fused by XLA into one
  streaming pass over the haystack;
* long needles: a two-stage exact scheme — stage 1 compares the first/middle/
  last 4-byte words (the reference's "anomaly" idea made dense,
  ``find/serial.h:35``), stage 2 verifies the (rare) surviving candidates
  one-by-one with a bounded ``lax.while_loop`` of exact dynamic-slice
  compares — still exact for adversarial inputs;
* bytesets are a 256-bit bitset evaluated with 8 word-selects + a bit test
  (``sz_find_byteset``, reference ``find.h:272``), no gathers;
* positions are int32 (buffers < 2 GiB); "not found" is -1 (the Python
  binding convention; the C ABI's NULL return maps to it).

Shape discipline: haystacks are padded to dyadic lengths and the true length
travels as a runtime scalar, so there are O(log max_len) compiled
specializations per needle *length* — never per needle or per exact size.

Multi-chip: ``parallel.cross.sharded_find`` shards the haystack over the mesh
with a (needle-1)-byte halo and combines per-shard results with a min/max
collective — the reference has no analog (single-node only).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "find",
    "rfind",
    "find_byte",
    "rfind_byte",
    "count",
    "count_byte",
    "find_byteset",
    "rfind_byteset",
    "byteset_mask",
    "match_mask",
    "search_positions",
    "find_long",
]

_DENSE_NEEDLE_LIMIT = 64  # dense shifted-compare tier bound
_MIN_PAD = 256


def _dyadic(n: int) -> int:
    n = max(int(n), _MIN_PAD)
    return 1 << (n - 1).bit_length()


def _as_u8_padded(x) -> tuple[jnp.ndarray, int]:
    """Byte array padded to a dyadic length + the true length."""
    if isinstance(x, str):
        x = x.encode("utf-8")
    if isinstance(x, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(bytes(x), dtype=np.uint8)
    else:
        buf = np.asarray(x, dtype=np.uint8)
    n = buf.shape[0]
    if isinstance(x, jnp.ndarray) and x.shape[0] == _dyadic(n):
        return x, n
    padded = np.zeros(_dyadic(n), dtype=np.uint8)
    padded[:n] = buf
    return jnp.asarray(padded), n


def _needle_arr(needle) -> tuple[jnp.ndarray, int]:
    if isinstance(needle, str):
        needle = needle.encode("utf-8")
    if isinstance(needle, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(needle), dtype=np.uint8)
    else:
        arr = np.asarray(needle, dtype=np.uint8)
    return jnp.asarray(arr), arr.shape[0]


def byteset_mask(charset) -> np.ndarray:
    """256-bit byteset as 8 uint32 words (``sz_byteset_t``; consumed by
    ``sz_find_byteset``, reference ``find.h:272``)."""
    words = np.zeros(8, dtype=np.uint32)
    data = charset if isinstance(charset, (bytes, bytearray)) else bytes(charset)
    for b in data:
        words[b >> 5] |= np.uint32(1 << (b & 31))
    return words


# ---------------------------------------------------------------------------
# Match masks (jitted once per needle-length k and dyadic haystack size)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k",))
def _dense_match_mask(hay: jnp.ndarray, n, needle_arr: jnp.ndarray, k: int) -> jnp.ndarray:
    """``mask[p] = hay[p:p+k] == needle`` — k shifted compares fused by XLA
    into one streaming pass. Needle chars are runtime scalars, so new
    needles of the same length reuse the executable."""
    h = hay.astype(jnp.int32)
    nd = needle_arr.astype(jnp.int32)
    mask = jnp.ones(h.shape, dtype=jnp.bool_)
    for a in range(k):
        shifted = jnp.roll(h, -a) if a else h
        mask = mask & (shifted == nd[a])
    pos = jnp.arange(h.shape[0])
    return mask & (pos < n - k + 1)


def match_mask(haystack, needle) -> jnp.ndarray:
    """Boolean occurrence mask over the (padded) haystack. For tests/benches."""
    hay, n = _as_u8_padded(haystack)
    nd, k = _needle_arr(needle)
    return _dense_match_mask(hay, n, nd, k)


@partial(jax.jit, static_argnames=("k",))
def _candidate_mask_long(hay: jnp.ndarray, n, needle_arr: jnp.ndarray, k: int) -> jnp.ndarray:
    """Stage-1 exact-candidate mask for long needles: compare 4-byte words at
    the first / middle / last offsets (the reference's anomaly offsets,
    ``find/serial.h:35``, made dense). No false negatives by construction."""
    h = hay.astype(jnp.int32)

    def word_at(off):
        out = jnp.zeros(h.shape, jnp.int32)
        for b in range(4):
            out = out | (jnp.roll(h, -(off + b)) << (8 * b))
        return out

    def needle_word(off):
        w = jnp.int32(0)
        for b in range(4):
            w = w | (needle_arr[off + b].astype(jnp.int32) << (8 * b))
        return w

    offs = (0, (k // 2) & ~3, (k - 4) & ~3)
    mask = jnp.ones(h.shape, dtype=jnp.bool_)
    for off in dict.fromkeys(offs):  # dedupe, keep order
        mask = mask & (word_at(off) == needle_word(off))
    pos = jnp.arange(h.shape[0])
    return mask & (pos < n - k + 1)


@partial(jax.jit, static_argnames=("k", "reverse"))
def _verify_candidates(hay: jnp.ndarray, needle_arr: jnp.ndarray, cand: jnp.ndarray,
                       k: int, reverse: bool) -> jnp.ndarray:
    """Stage 2: walk candidates (first-to-last or last-to-first) with exact
    k-byte compares until one verifies. Expected trips ≈ 1 — stage 1's
    12-byte filter passes ~2^-96 of random positions."""
    n = hay.shape[0]
    big = jnp.int32(n + 1)

    def next_cand(c):
        if reverse:
            idx = jnp.max(jnp.where(c, jnp.arange(n, dtype=jnp.int32), jnp.int32(-1)))
            return jnp.where(idx >= 0, idx, big)
        idx = jnp.min(jnp.where(c, jnp.arange(n, dtype=jnp.int32), big))
        return idx

    def cond(state):
        pos, found, _ = state
        return (~found) & (pos < big)

    def body(state):
        pos, _, c = state
        start = jnp.clip(pos, 0, n - k).astype(jnp.int32)
        window = jax.lax.dynamic_slice_in_dim(hay, start, k)
        ok = jnp.all(window == needle_arr[:k])
        c = c.at[jnp.clip(pos, 0, n - 1)].set(False)
        return jnp.where(ok, pos, next_cand(c)), ok, c

    pos0 = next_cand(cand)
    pos, found, _ = jax.lax.while_loop(cond, body, (pos0, jnp.asarray(False), cand))
    return jnp.where(found, pos, jnp.int32(-1))


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


@jax.jit
def _first_true(mask: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(jnp.any(mask), jnp.argmax(mask).astype(jnp.int32), jnp.int32(-1))


@jax.jit
def _last_true(mask: jnp.ndarray) -> jnp.ndarray:
    n = mask.shape[0]
    return jnp.max(jnp.where(mask, jnp.arange(n, dtype=jnp.int32), jnp.int32(-1)))


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------


def find(haystack, needle) -> int:
    """Offset of the first occurrence, -1 if absent (``sz_find``, reference
    ``find.h:144``). Empty needle → 0, matching the reference wrappers."""
    hay, n = _as_u8_padded(haystack)
    nd, k = _needle_arr(needle)
    if k == 0:
        return 0
    if n < k:
        return -1
    if k <= _DENSE_NEEDLE_LIMIT:
        return int(_first_true(_dense_match_mask(hay, n, nd, k)))
    cand = _candidate_mask_long(hay, n, nd, k)
    return int(_verify_candidates(hay, nd, cand, k, False))


def rfind(haystack, needle) -> int:
    """Offset of the last occurrence (``sz_rfind``, reference ``find.h:156``)."""
    hay, n = _as_u8_padded(haystack)
    nd, k = _needle_arr(needle)
    if k == 0:
        return n
    if n < k:
        return -1
    if k <= _DENSE_NEEDLE_LIMIT:
        return int(_last_true(_dense_match_mask(hay, n, nd, k)))
    cand = _candidate_mask_long(hay, n, nd, k)
    return int(_verify_candidates(hay, nd, cand, k, True))


def find_byte(haystack, byte: int) -> int:
    """First occurrence of one byte (``sz_find_byte``, reference ``find.h:43``)."""
    hay, n = _as_u8_padded(haystack)
    if n == 0:
        return -1
    mask = (hay == jnp.uint8(byte)) & (jnp.arange(hay.shape[0]) < n)
    return int(_first_true(mask))


def rfind_byte(haystack, byte: int) -> int:
    hay, n = _as_u8_padded(haystack)
    if n == 0:
        return -1
    mask = (hay == jnp.uint8(byte)) & (jnp.arange(hay.shape[0]) < n)
    return int(_last_true(mask))


def count(haystack, needle, allowoverlap: bool = True) -> int:
    """Occurrence count. Overlapping by default (mask popcount); greedy
    left-to-right otherwise (Python ``str.count`` semantics, the binding's
    ``Str.count`` contract — delegated to C-speed ``bytes.count``)."""
    nd, k = _needle_arr(needle)
    if not allowoverlap:
        # greedy non-overlapping count IS bytes.count — C speed, exact
        if isinstance(haystack, str):
            haystack = haystack.encode("utf-8")
        if not isinstance(haystack, (bytes, bytearray, memoryview)):
            haystack = np.asarray(haystack, dtype=np.uint8).tobytes()
        return bytes(haystack).count(bytes(np.asarray(nd, np.uint8).tobytes()))
    hay, n = _as_u8_padded(haystack)
    if k == 0:
        return n + 1
    if n < k:
        return 0
    if k <= _DENSE_NEEDLE_LIMIT:
        return int(jnp.sum(_dense_match_mask(hay, n, nd, k)))
    cand = np.asarray(_candidate_mask_long(hay, n, nd, k))
    hb, nb = np.asarray(hay), np.asarray(nd)
    total = 0
    for p in np.nonzero(cand)[0]:
        total += bool((hb[p : p + k] == nb).all())
    return total


def count_byte(haystack, byte: int) -> int:
    hay, n = _as_u8_padded(haystack)
    mask = (hay == jnp.uint8(byte)) & (jnp.arange(hay.shape[0]) < n)
    return int(jnp.sum(mask))


@jax.jit
def _byteset_hits(hay: jnp.ndarray, n, words: jnp.ndarray) -> jnp.ndarray:
    """``hit[p] = bitset[hay[p]]`` via 8 word-selects + a bit test — no
    gathers (the dense analog of the reference's vectorized byteset probes)."""
    h = hay.astype(jnp.int32)
    widx = h >> 5
    bit = h & 31
    word = jnp.zeros(h.shape, jnp.uint32)
    for w in range(8):
        word = jnp.where(widx == w, words[w], word)
    hit = ((word >> bit.astype(jnp.uint32)) & jnp.uint32(1)).astype(jnp.bool_)
    return hit & (jnp.arange(h.shape[0]) < n)


def find_byteset(haystack, charset) -> int:
    """First byte ∈ set (``sz_find_byteset``, reference ``find.h:272``)."""
    hay, n = _as_u8_padded(haystack)
    if n == 0:
        return -1
    return int(_first_true(_byteset_hits(hay, n, jnp.asarray(byteset_mask(charset)))))


def rfind_byteset(haystack, charset) -> int:
    """Last byte ∈ set (``sz_rfind_byteset``, reference ``find.h:290``)."""
    hay, n = _as_u8_padded(haystack)
    if n == 0:
        return -1
    return int(_last_true(_byteset_hits(hay, n, jnp.asarray(byteset_mask(charset)))))


# ---------------------------------------------------------------------------
# Search over a device mirror — the ``Str`` device tier
# ---------------------------------------------------------------------------
#
# ``Str`` mirrors big buffers to the device as a ``(rows, 128)`` u8 array.
# One jitted pass per (mode, needle length) compares every start position
# at once: needles <= MAX_OFFSETS bytes compare in full (exact); longer
# needles are *filtered* on <= MAX_OFFSETS anomaly bytes and the rare
# surviving candidates verified exactly (``find_long``).

LANES = 128
BLOCK_ROWS = 1024  # mirror padding granularity: 128 KiB
MAX_OFFSETS = 16  # compared needle bytes per pass
_NOT_FOUND = 2**31 - 1


@partial(jax.jit, static_argnames=("mode", "offsets"))
def _search(hay2d, params, bounds, *, mode: str, offsets: tuple):
    """``offsets=()`` probes the 256-bit byteset in ``params``; otherwise
    ``params[s]`` must equal ``hay[p + offsets[s]]`` for every slot."""
    h = hay2d.reshape(-1).astype(jnp.int32)
    N = h.shape[0]
    if offsets:
        mask = None
        for slot, a in enumerate(offsets):
            shifted = h if a == 0 else jnp.concatenate(
                [h[a:], jnp.zeros((a,), jnp.int32)])
            eq = shifted == params[slot]
            mask = eq if mask is None else mask & eq
    else:
        word = jnp.zeros(h.shape, jnp.int32)
        for w in range(8):
            word = jnp.where((h >> 5) == w, params[w], word)
        mask = ((word >> (h & 31)) & 1) == 1
    pos = jnp.arange(N, dtype=jnp.int32)
    valid = mask & (pos >= bounds[0]) & (pos <= bounds[1])
    if mode == "first":
        r = jnp.min(jnp.where(valid, pos, _NOT_FOUND))
        return jnp.where(r == _NOT_FOUND, -1, r)
    if mode == "last":
        return jnp.max(jnp.where(valid, pos, -1))
    return jnp.sum(valid.astype(jnp.int32))


def _anomaly_offsets(k: int) -> tuple:
    """<= MAX_OFFSETS distinguishing byte offsets for a k-byte needle: the
    first/middle/last 4-byte words plus spread extras (the reference picks 3
    "anomaly" chars, ``find/serial.h:35``)."""
    reach = k - 1
    offs = set(range(min(k, 4)))
    offs |= {reach - 3 + b for b in range(4) if reach - 3 + b >= 0}
    mid = (reach // 2) & ~3
    offs |= {mid + b for b in range(4) if mid + b <= reach}
    step = max(reach // 4, 1)
    probe = step
    while len(offs) < MAX_OFFSETS and probe < reach:
        offs.add(probe)
        probe += step
    return tuple(sorted(offs)[:MAX_OFFSETS])


def search_positions(
    hay2d: jnp.ndarray,  # (rows, 128) uint8 device mirror
    n: int,  # true byte length
    mode: str,  # first | last | count
    needle: np.ndarray | None = None,  # (k,) uint8
    byteset_words: np.ndarray | None = None,  # (8,) uint32
    lo: int = 0,
    hi: int | None = None,
) -> jnp.ndarray:
    """Search over valid start positions in ``[lo, hi]``.

    Exact for needles <= MAX_OFFSETS bytes and for bytesets; longer needles
    get the *candidate* semantics (possible false positives) — use
    ``find_long``. Returns () int32: position, -1, or count."""
    if needle is not None:
        k = int(needle.shape[0])
        offsets = tuple(range(k)) if k <= MAX_OFFSETS else _anomaly_offsets(k)
        params = np.array([needle[a] for a in offsets], dtype=np.int32)
    else:
        k = 1
        offsets = ()
        params = np.asarray(byteset_words, dtype=np.uint32).view(np.int32)
    hi = n - k if hi is None else min(hi, n - k)
    bounds = np.array([lo, hi], dtype=np.int32)
    return _search(hay2d, jnp.asarray(params), jnp.asarray(bounds),
                   mode=mode, offsets=offsets)


@partial(jax.jit, static_argnames=("k",))
def _verify_window(hay2d, p, needle, k: int):
    """Exact k-byte compare of hay2d[p : p+k] (flat) vs needle."""
    window = jax.lax.dynamic_slice_in_dim(hay2d.reshape(-1), p, k)
    return jnp.all(window == needle)


def find_long(hay2d: jnp.ndarray, n: int, needle: np.ndarray,
              reverse: bool = False) -> int:
    """Exact first/last match for needles longer than MAX_OFFSETS: anomaly
    filter + per-candidate exact verification (expected 1 round)."""
    k = int(needle.shape[0])
    nd = jnp.asarray(needle)
    lo, hi = 0, n - k
    while lo <= hi:
        cand = int(search_positions(hay2d, n, "last" if reverse else "first",
                                    needle=needle, lo=lo, hi=hi))
        if cand < 0:
            return -1
        if bool(_verify_window(hay2d, jnp.int32(cand), nd, k)):
            return cand
        if reverse:
            hi = cand - 1
        else:
            lo = cand + 1
    return -1
