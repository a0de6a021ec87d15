"""Rolling MinHash / Count-Min fingerprints — parameters and exact oracle.

Re-implements the semantics of the reference's production fingerprint engine
(``floating_rolling_hashers<f64>``, reference
``include/stringzillas/fingerprints/serial.hpp:1111-1330``):

* per-dimension multiplier ``256 + splitmix64(seed+dim) % 384`` and modulo
  ``4503599626977 - splitmix64(splitmix64(seed+dim)) % 2^20``
  (``serial.hpp:1322-1336``);
* state update ``state = (state*mult + (char+1)) mod m`` (push) and the fused
  discard+push roll (``serial.hpp:530-555``) — all integer-valued and exact in
  f64's 52-bit mantissa;
* per-dimension running minimum of the rolling hash plus a count-min of how
  many windows attained it (``serial.hpp:1260-1280``);
* docs shorter than the window → ``min_hash = 0xFFFFFFFF``, ``count = 0``
  (``serial.hpp:1181-1186``); export truncates the 42-bit minimum to u32.

Dimension→window-width mapping mirrors ``szs_fingerprints_init`` (reference
``c/stringzillas/fingerprints.cuh:31-170``): when ``ndim`` splits evenly into
64-dim slices per width, slice ``i`` takes ``widths[i % len]`` (block mapping);
otherwise dimension ``d`` takes ``widths[d % len]`` (interleaved fallback).

The oracle here computes in integer-exact NumPy f64 — bit-identical to the C
engines. The device form (:func:`fingerprint_all_groups`) reproduces the same
values in int32 limb arithmetic, validated against this oracle and the golden
vectors.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "DEFAULT_WINDOW_WIDTHS",
    "MODULO_BASE",
    "band_keys",
    "derive_params",
    "fingerprint_all_groups",
    "fingerprint_oracle",
    "pack_limbs",
    "splitmix64",
]


def band_keys(min_hashes, bands: int):
    """Per-band LSH bucket keys, computed where the min-hashes live:
    ``(n, ndim) uint32 -> (n, bands) uint32``.

    Each band's ``ndim // bands`` hashes fold through a golden-ratio
    multiply-add chain with a final avalanche; equal band slices always map
    to equal keys, so hash collisions can only ADD candidate pairs — which
    the LSH consumer verifies anyway (``examples/dedup_minhash.py``).

    Accepts a device (jax) array — the intended use with
    ``Fingerprints(..., device_out=True)``, pulling 4*bands bytes/doc
    instead of 8*ndim — or a host numpy array (same bits either way;
    int32 arithmetic wraps mod 2^32 on both).

    Reference analog: the hashed-band bucketing its docs recommend over
    ``szs::Fingerprints`` output (README.md:931-943); the reference leaves
    banding to the caller, so the key mix here is this framework's own.
    """
    import jax.lax
    import jax.numpy as jnp

    x = jnp.asarray(min_hashes).view(jnp.int32)
    n, ndim = x.shape
    if ndim % bands:
        raise ValueError(f"ndim {ndim} not divisible into {bands} bands")
    r = ndim // bands
    t = x.reshape(n, bands, r)
    key = jnp.zeros((n, bands), jnp.int32)
    for j in range(r):  # static unroll: r is small (4-16)
        key = key * jnp.int32(-1640531527) + t[:, :, j]  # 2^32 / phi
    # final avalanche (murmur3-style) so low-entropy tails still spread
    key = key ^ jax.lax.shift_right_logical(key, 16)
    key = key * jnp.int32(-2048144789)
    key = key ^ jax.lax.shift_right_logical(key, 13)
    return key.view(jnp.uint32)

DEFAULT_WINDOW_WIDTHS = (3, 4, 5, 7, 9, 11, 15, 31)  # fingerprints.cuh:42
MODULO_BASE = 4503599626977  # serial.hpp:1247 default_modulo_base_k
FINGERPRINT_SLICE = 64  # stringzillas.cuh:771
MAX_HASH_U32 = np.uint32(0xFFFFFFFF)


def splitmix64(state: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 finalizer (reference ``serial.hpp:44-50``)."""
    state = np.asarray(state, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = state + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def dim_window_widths(ndim: int, widths: tuple[int, ...]) -> np.ndarray:
    """Per-dimension window width, following the sliced/fallback rule of
    ``szs_fingerprints_init`` (fingerprints.cuh:54-58)."""
    widths = tuple(int(w) for w in widths)
    n_widths = len(widths)
    per_w_min = ndim // n_widths
    sliced = (ndim % n_widths == 0) and (per_w_min % FINGERPRINT_SLICE == 0)
    dims = np.arange(ndim)
    if sliced:
        return np.array(widths, dtype=np.int64)[(dims // FINGERPRINT_SLICE) % n_widths]
    return np.array(widths, dtype=np.int64)[dims % n_widths]


def derive_params(ndim: int, window_widths=None, seed: int = 0):
    """Per-dimension (window_width, multiplier, modulo, discarding multipliers).

    Returns a dict of int64 arrays of shape (ndim,). ``neg_disc`` is the value
    ``(multiplier^(w-1)) mod m`` (the reference negates it; we keep the positive
    magnitude) and ``fused_disc`` is the non-negative complement
    ``(m - neg_disc*mult mod m)`` used by the fused roll (serial.hpp:500-506).
    """
    widths = tuple(window_widths) if window_widths else DEFAULT_WINDOW_WIDTHS
    w = dim_window_widths(ndim, widths)
    dims = np.arange(ndim, dtype=np.uint64)
    seed_u = np.uint64(seed)
    with np.errstate(over="ignore"):
        mult = (256 + (splitmix64(seed_u + dims) % np.uint64(384))).astype(np.int64)
        modulo = (np.uint64(MODULO_BASE) - (splitmix64(splitmix64(seed_u + dims)) % np.uint64(1 << 20))).astype(np.int64)
    # highest_power = mult^(w-1) mod m, per-dim (python ints: exact).
    neg_disc = np.array(
        [pow(int(m_), int(w_) - 1, int(mod_)) for m_, w_, mod_ in zip(mult, w, modulo)],
        dtype=np.int64,
    )
    fused_disc = np.array(
        [(int(mod_) - (int(nd_) * int(m_)) % int(mod_)) % int(mod_)
         for nd_, m_, mod_ in zip(neg_disc, mult, modulo)],
        dtype=np.int64,
    )
    return {
        "width": w.astype(np.int64),
        "mult": mult,
        "modulo": modulo,
        "neg_disc": neg_disc,
        "fused_disc": fused_disc,
    }


def fingerprint_oracle(doc: bytes, params) -> tuple[np.ndarray, np.ndarray]:
    """Exact reference fingerprint of one document: ``(min_hashes u32[ndim],
    min_counts u32[ndim])``. Vectorized over dimensions; all intermediate
    values are integers < 2^52, exact in f64."""
    w = params["width"]
    mult = params["mult"].astype(np.float64)
    modulo = params["modulo"].astype(np.float64)
    neg_disc = params["neg_disc"].astype(np.float64)
    ndim = len(w)
    data = np.frombuffer(doc, dtype=np.uint8).astype(np.float64)
    n = len(data)

    state = np.zeros(ndim, dtype=np.float64)
    minimum = np.full(ndim, np.inf)
    count = np.zeros(ndim, dtype=np.uint32)
    alive = np.zeros(ndim, dtype=bool)  # window filled at least once

    max_w = int(w.max()) if ndim else 0
    for t in range(n):
        new_term = data[t] + 1.0
        pushing = t < w
        # push: state = (state*mult + term) mod m
        pushed = np.mod(state * mult + new_term, modulo)
        # roll: discard the char leaving the window, then push.
        # old_char index t - w differs per dim; gather it.
        old_idx = t - w
        old_terms = np.where(old_idx >= 0, data[np.clip(old_idx, 0, None)] + 1.0, 0.0)
        without_old = np.mod(state - neg_disc * old_terms, modulo)
        rolled = np.mod(without_old * mult + new_term, modulo)
        state = np.where(pushing, pushed, rolled)

        # Record first full window: min = state, count = 1.
        first_full = t == (w - 1)
        became = first_full & ~alive
        minimum = np.where(became, state, minimum)
        count = np.where(became, 1, count).astype(np.uint32)
        alive = alive | became
        # Subsequent windows: branchless count-min update.
        update = alive & ~first_full & (t >= w)
        count = np.where(update & (state < minimum), 1, count).astype(np.uint32)
        count = np.where(update & (state == minimum), count + 1, count).astype(np.uint32)
        minimum = np.where(update, np.minimum(minimum, state), minimum)

    finite_min = np.where(alive, minimum, 0.0)  # dead dims hold inf
    min_hashes = np.where(
        alive, (finite_min.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        MAX_HASH_U32
    ).astype(np.uint32)
    min_counts = np.where(alive, count, np.uint32(0)).astype(np.uint32)
    return min_hashes, min_counts


# ---------------------------------------------------------------------------
# Baseline rolling hashers (reference ``fingerprints/serial.hpp:56-263``) —
# the reference keeps these as validation baselines for the production
# floating hasher; same role here, vectorized numpy.
# ---------------------------------------------------------------------------


def multiplying_rolling_hash(doc: bytes, window: int, multiplier: int = 257,
                             bits: int = 32) -> np.ndarray:
    """Power-of-two-modulo polynomial roll (``multiplying_rolling_hasher``,
    reference ``serial.hpp:56-95``): one hash per full window."""
    data = np.frombuffer(doc, dtype=np.uint8).astype(np.uint64)
    n = len(data)
    if n < window:
        return np.zeros(0, dtype=np.uint64)
    mask = np.uint64((1 << bits) - 1)
    mult = np.uint64(multiplier)
    with np.errstate(over="ignore"):
        disc = np.uint64(pow(multiplier, window - 1, 1 << bits))
        out = np.empty(n - window + 1, dtype=np.uint64)
        state = np.uint64(0)
        for t in range(window):
            state = (state * mult + data[t] + np.uint64(1)) & mask
        out[0] = state
        for t in range(window, n):
            state = ((state - disc * (data[t - window] + np.uint64(1))) * mult
                     + data[t] + np.uint64(1)) & mask
            out[t - window + 1] = state
    return out


def rabin_karp_rolling_hash(doc: bytes, window: int, multiplier: int = 257,
                            modulo: int = MODULO_BASE) -> np.ndarray:
    """Modular polynomial roll with a co-prime modulo
    (``rabin_karp_rolling_hasher``, reference ``serial.hpp:109-188``)."""
    data = np.frombuffer(doc, dtype=np.uint8).astype(object)
    n = len(data)
    if n < window:
        return np.zeros(0, dtype=np.uint64)
    disc = pow(multiplier, window - 1, modulo)
    out = np.empty(n - window + 1, dtype=np.uint64)
    state = 0
    for t in range(window):
        state = (state * multiplier + int(data[t]) + 1) % modulo
    out[0] = state
    for t in range(window, n):
        state = ((state - disc * (int(data[t - window]) + 1)) * multiplier
                 + int(data[t]) + 1) % modulo
        out[t - window + 1] = state
    return out


def buz_rolling_hash(doc: bytes, window: int, seed: int = 0) -> np.ndarray:
    """BuzHash: rotate-XOR with a random byte table
    (``buz_rolling_hasher``, reference ``serial.hpp:195-263``)."""
    table = splitmix64(np.uint64(seed) + np.arange(256, dtype=np.uint64))
    data = np.frombuffer(doc, dtype=np.uint8)
    n = len(data)
    if n < window:
        return np.zeros(0, dtype=np.uint64)

    def rotl(x, k):
        k = np.uint64(k % 64)
        return (x << k | x >> (np.uint64(64) - k)) & np.uint64(0xFFFFFFFFFFFFFFFF) if k else x

    with np.errstate(over="ignore"):
        out = np.empty(n - window + 1, dtype=np.uint64)
        state = np.uint64(0)
        for t in range(window):
            state = rotl(state, 1) ^ table[data[t]]
        out[0] = state
        for t in range(window, n):
            state = (rotl(state, 1) ^ rotl(table[data[t - window]], window)
                     ^ table[data[t]])
            out[t - window + 1] = state
    return out


# ---------------------------------------------------------------------------
# Device form — exact 52-bit modular arithmetic in int32 limbs
# ---------------------------------------------------------------------------
#
# The reference's hasher only ever manipulates *integers* below 2^52, and its
# moduli sit just past 2^42 (``default_modulo_base_k``, serial.hpp:1247). The
# state is held exactly in TWO int32 limbs — (low 21 bits, open-ended rest) —
# chosen so every product stays inside int32:
#
# * ``s0*mult <= (2^21-1)*639 ~ 1.34e9`` and the top limb
#   ``s1 <= m>>21 ~ 2147484`` gives ``s1*mult ~ 1.37e9``;
# * the fused roll ``x = state*mult + fused_disc*old_term + new_term`` needs
#   no third limb: the open-ended ``p1`` carries ``x = p1*2^21 + p0 < 2^52``;
# * Barrett reduction with an f32 quotient *estimate* and exact integer
#   correction: ``q ~ floor(x * 1/m)`` may be off by one either way
#   (``q*m1 <= 897*2147484 < 2^31``), so one conditional ``+m`` and one
#   conditional ``-m`` pin ``r = x mod m`` exactly, whatever rounding the
#   estimate took (a fused multiply-add only makes it closer);
# * the running minimum is tracked lexicographically over the limb pair and
#   truncated to u32 on export (``serial.hpp:1284-1293``).

LIMB = 21
MASK = (1 << LIMB) - 1
SENTINEL_HI = 1 << 22  # valid top limbs are <= ~2^21.04


def pack_limbs(values: np.ndarray) -> np.ndarray:
    """int64 (G,) → (2, G) int32 limbs (low 21 bits, open-ended rest)."""
    v = np.asarray(values, dtype=np.int64)
    return np.stack([(v & MASK).astype(np.int32), (v >> LIMB).astype(np.int32)])


@partial(jax.jit, static_argnames=("group_sizes",))
def _fingerprint_all_groups(docs_t, lens, widths, mult, m_limbs, fd_limbs,
                            inv_m, group_sizes: tuple):
    doc_len, n_docs = docs_t.shape
    dims = mult.shape[0]
    terms = docs_t.astype(jnp.int32) + 1  # byte terms (+1)
    m0, m1 = m_limbs[0], m_limbs[1]
    f0, f1 = fd_limbs[0], fd_limbs[1]
    wrow = jnp.concatenate([jnp.full((sz, 1), widths[0, g], jnp.int32)
                            for g, sz in enumerate(group_sizes)], axis=0)
    zeros = jnp.zeros((dims, n_docs), jnp.int32)
    init = (zeros, zeros, zeros,
            jnp.full((dims, n_docs), SENTINEL_HI, jnp.int32), zeros)

    def body(carry, t):
        s0, s1, mn0, mn1, count = carry
        term = terms[t][None, :]
        # discarded term per group: zero while the window still fills
        # (t < w), turning the fused roll into a plain push
        old_term = jnp.concatenate([
            jnp.broadcast_to(jnp.where(t >= widths[0, g],
                                       terms[jnp.maximum(t - widths[0, g], 0)],
                                       0)[None, :], (sz, n_docs))
            for g, sz in enumerate(group_sizes)], axis=0)
        p0 = s0 * mult + f0 * old_term + term
        p1 = s1 * mult + f1 * old_term
        p1 += p0 >> LIMB
        p0 &= MASK
        xf = p1.astype(jnp.float32) * 2097152.0 + p0.astype(jnp.float32)
        q = jnp.maximum(jnp.floor(xf * inv_m).astype(jnp.int32), 0)
        r0 = p0 - q * m0
        r1 = p1 - q * m1
        r1 += r0 >> LIMB
        r0 &= MASK
        neg = r1 < 0
        a0 = r0 + jnp.where(neg, m0, 0)
        a1 = r1 + jnp.where(neg, m1, 0)
        a1 += a0 >> LIMB
        a0 &= MASK
        ge = (a1 > m1) | ((a1 == m1) & (a0 >= m0))
        s0 = a0 - jnp.where(ge, m0, 0)
        s1 = a1 - jnp.where(ge, m1, 0)
        s1 += s0 >> LIMB
        s0 &= MASK
        # a row's hash is a full-window value from t = w-1 onward; docs
        # shorter than the window never update
        upd = (t >= wrow - 1) & (t < lens)
        lt = (s1 < mn1) | ((s1 == mn1) & (s0 < mn0))
        eq = (s1 == mn1) & (s0 == mn0)
        count = jnp.where(upd & lt, 1, jnp.where(upd & eq, count + 1, count))
        take = upd & lt
        return (s0, s1, jnp.where(take, s0, mn0), jnp.where(take, s1, mn1),
                count), None

    (_, _, mn0, mn1, count), _ = jax.lax.scan(
        body, init, jnp.arange(doc_len, dtype=jnp.int32))
    skipped = mn1 >= SENTINEL_HI
    hash32 = (mn1 << LIMB) | mn0  # low 32 bits of the ~42-bit minimum
    return (jnp.where(skipped, jnp.int32(-1), hash32),
            jnp.where(skipped, 0, count))


def fingerprint_all_groups(
    docs_t,  # (doc_len, n_docs) int32/uint8 — docs across lanes
    lens,  # (1, n_docs) int32
    widths,  # (1, n_groups) int32 — per-group window widths
    group_sizes: tuple,  # static: dims rows per width group, concat order
    mult,  # (dims, 1) int32
    m_limbs,  # (2, dims, 1) int32
    fd_limbs,  # (2, dims, 1) int32
    inv_m,  # (dims, 1) float32
):
    """MinHash + count-min for every dimension of every window width in one
    pass over the document bytes. Returns ``(min_hash int32 (dims, n_docs),
    counts int32 (dims, n_docs))``; min_hash bit patterns are the u32
    hashes."""
    return _fingerprint_all_groups(
        docs_t, lens, widths, mult, m_limbs, fd_limbs, inv_m,
        group_sizes=tuple(int(s) for s in group_sizes))
