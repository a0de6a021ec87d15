"""Myers bit-parallel Levenshtein — 32 DP cells per int32 word.

Re-design of the reference's ``levenshtein_distance_myers`` (reference
``include/stringzillas/similarities/serial.hpp:2163-2417``: Myers/Hyyrö
bit-vector edit distance, unrolled word tiers). A query of length m uses
``W = ceil(m/32)`` int32 words; per candidate character the state advances
as

    Xv = Eq | VN
    Xh = (((Eq & VP) + VP) ^ VP) | Eq          (carry chained across words)
    Ph = VN | ~(Xh | VP);  Mh = VP & Xh
    Ph = (Ph << 1) | 1;  Mh <<= 1              (bit 31 carried across words)
    VP = Mh | ~(Xv | Ph);  VN = Ph & Xv

``Eq`` comes from a per-query PEQ table (``peq[q, code, w]`` = the bits of
word ``w`` where the query holds ``code``), built once per call by one
scatter — the reference's 256-entry PEQ (``serial.hpp:2189``). Byte engines
use the byte as the code; rune engines map runes to ranks in the sorted set
of the batch's query runes (an absent rune gets an all-zero row), so one
table layout serves both.

Two forms compute the same distances:

* :func:`myers_kernel` — a Pallas kernel on the Triton route: one program
  scores one query against a block of ``LANE_BLOCK`` candidates, keeps the
  ``2W`` state words of every pair in registers and reads ``Eq`` by a gather
  from the query's PEQ row (L1-resident). Used on the GPU for ``W <=``
  ``MAX_KERNEL_WORDS``.
* :func:`myers_reference` — plain XLA over ``(W, queries, candidates)``
  state with a Kogge-Stone carry across words; the CPU tier, the long-query
  tier, and the reference the kernel is tested against.

End-only scoring: lanes freeze at their own length, where the Myers
invariant gives ``D[m][n] = n + popcnt(VP & mask) - popcnt(VN & mask)``
with ``mask`` = bits ``[0, m)``. Unit costs only — the configurations the
reference routes to Myers (``serial.hpp:2620-2720``). Exact int32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils import platform

__all__ = ["myers_distances", "myers_kernel", "myers_reference", "encode",
           "LANE_BLOCK", "MAX_KERNEL_WORDS"]

INT_MIN = -(1 << 31)
LANE_BLOCK = 128  # candidates per kernel program
MAX_KERNEL_WORDS = 8  # longer queries (> 256 chars) take the XLA form
NUM_WARPS = 4


def _uless(a, b):
    """Unsigned a < b on int32 (sign-flip trick)."""
    return (a ^ INT_MIN) < (b ^ INT_MIN)


def vp_init(qlens, words: int):
    """``(n_queries, words)`` int32: bits ``[0, m)`` of each query set."""
    w = jnp.arange(words, dtype=jnp.int32)[None, :]
    in_word = jnp.clip(qlens.reshape(-1, 1).astype(jnp.int32) - 32 * w, 0, 32)
    return jnp.where(in_word >= 32, jnp.int32(-1),
                     jnp.left_shift(jnp.int32(1), jnp.minimum(in_word, 31)) - 1)


def build_peq(q_codes, alphabet: int):
    """``(n_queries, alphabet, words)`` int32 PEQ table from query codes
    ``(rows, n_queries)`` (``-1`` = padding, no bit). Distinct bits of one
    word add without carries, so the scatter-add is a bitwise OR."""
    rows, nq = q_codes.shape
    words = rows // 32
    r = np.arange(rows)
    bits = jnp.asarray((np.int64(1) << (r % 32)).astype(np.uint32).view(np.int32))
    code = jnp.where(q_codes >= 0, q_codes, alphabet)  # padding → dropped
    qi = jnp.broadcast_to(jnp.arange(nq, dtype=jnp.int32)[None, :], (rows, nq))
    wi = jnp.broadcast_to(jnp.asarray(r // 32, jnp.int32)[:, None], (rows, nq))
    peq = jnp.zeros((nq, alphabet, words), jnp.int32)
    return peq.at[qi, code, wi].add(
        jnp.broadcast_to(bits[:, None], (rows, nq)), mode="drop")


def _popcount(v):
    return jax.lax.population_count(v)


# ---------------------------------------------------------------------------
# Pallas kernel (Triton route)
# ---------------------------------------------------------------------------


def _kernel_step(VP, VN, Eq, live):
    """One candidate character for all W words held as separate arrays:
    the carry and the <<1 hand-off chain word to word, as the reference's
    unrolled word tiers do."""
    words = len(VP)
    Xv = [Eq[w] | VN[w] for w in range(words)]
    t = [Eq[w] & VP[w] for w in range(words)]
    s1 = [t[w] + VP[w] for w in range(words)]
    s = [s1[0]]
    c = _uless(s1[0], t[0]).astype(jnp.int32)  # carry out of word 0
    for w in range(1, words):
        s.append(s1[w] + c)
        g = _uless(s1[w], t[w]).astype(jnp.int32)
        c = g | jnp.where(s1[w] == -1, c, 0)
    Xh = [(s[w] ^ VP[w]) | Eq[w] for w in range(words)]
    Ph = [VN[w] | ~(Xh[w] | VP[w]) for w in range(words)]
    Mh = [VP[w] & Xh[w] for w in range(words)]
    PhS = [(Ph[0] << 1) | 1]
    MhS = [Mh[0] << 1]
    for w in range(1, words):
        PhS.append((Ph[w] << 1) | ((Ph[w - 1] >> 31) & 1))
        MhS.append((Mh[w] << 1) | ((Mh[w - 1] >> 31) & 1))
    VPn = tuple(jnp.where(live, MhS[w] | ~(Xv[w] | PhS[w]), VP[w])
                for w in range(words))
    VNn = tuple(jnp.where(live, PhS[w] & Xv[w], VN[w]) for w in range(words))
    return VPn, VNn


def _kernel(words: int, peq_ref, vp0_ref, cands_ref, clens_ref, out_ref):
    clens = clens_ref[0, :]  # (LANE_BLOCK,)
    vp0 = tuple(jnp.full(clens.shape, vp0_ref[0, w], jnp.int32)
                for w in range(words))
    vn0 = tuple(jnp.zeros(clens.shape, jnp.int32) for _ in range(words))

    def step(j, carry):
        VP, VN = carry
        base = cands_ref[j, :] * words  # PEQ row offset of each lane's char
        Eq = tuple(peq_ref[0, base + w] for w in range(words))
        return _kernel_step(VP, VN, Eq, j < clens)

    # Lanes freeze at their own end, so the block's longest candidate
    # bounds the trip count (callers length-sort candidates into blocks).
    VP, VN = jax.lax.fori_loop(0, jnp.max(clens), step, (vp0, vn0))
    delta = jnp.zeros(clens.shape, jnp.int32)
    for w in range(words):
        delta += _popcount(VP[w] & vp0[w]) - _popcount(VN[w] & vp0[w])
    out_ref[0, :] = clens + delta


@functools.lru_cache(maxsize=128)
def _build_kernel(words: int, alphabet: int, cand_len: int, n_queries: int,
                  n_cands: int, interpret: bool):
    grid = (n_queries, n_cands // LANE_BLOCK)
    return pl.pallas_call(
        functools.partial(_kernel, words),
        grid=grid,
        in_specs=[
            pl.BlockSpec((1, alphabet * words), lambda q, c: (q, 0)),
            pl.BlockSpec((1, words), lambda q, c: (q, 0)),
            pl.BlockSpec((cand_len, LANE_BLOCK), lambda q, c: (0, c)),
            pl.BlockSpec((1, LANE_BLOCK), lambda q, c: (0, c)),
        ],
        out_specs=pl.BlockSpec((1, LANE_BLOCK), lambda q, c: (q, c)),
        out_shape=jax.ShapeDtypeStruct((n_queries, n_cands), jnp.int32),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        backend="triton",
        name="myers_levenshtein",
    )


@functools.partial(jax.jit, static_argnames=("alphabet", "interpret"))
def _myers_kernel_jit(q_codes, qlens, c_codes, clens, alphabet: int,
                      interpret: bool):
    rows, nq = q_codes.shape
    cand_len, nc = c_codes.shape
    words = rows // 32
    pad = (-nc) % LANE_BLOCK
    if pad:
        c_codes = jnp.pad(c_codes, ((0, 0), (0, pad)))
        clens = jnp.pad(clens, ((0, 0), (0, pad)))
    # Length sort: each program's trip count is its block's longest
    # candidate, so length-homogeneous blocks skip the padded tail.
    order = jnp.argsort(clens[0])
    c_sorted = jnp.take(c_codes, order, axis=1)
    l_sorted = jnp.take(clens, order, axis=1)
    peq = build_peq(q_codes, alphabet).reshape(nq, alphabet * words)
    call = _build_kernel(words, alphabet, cand_len, nq, nc + pad, interpret)
    out = call(peq, vp_init(qlens, words), c_sorted, l_sorted)
    out = jnp.take(out, jnp.argsort(order), axis=1)
    return out[:, :nc]


def myers_kernel(q_codes, qlens, c_codes, clens, alphabet: int = 256):
    """Distances ``(n_queries, n_cands) int32`` through the Pallas kernel;
    arguments as :func:`myers_distances` after :func:`encode`. Interpret
    mode on the CPU backend only."""
    words = q_codes.shape[0] // 32
    if words > MAX_KERNEL_WORDS:
        raise ValueError(f"kernel holds at most {MAX_KERNEL_WORDS} words")
    return _myers_kernel_jit(q_codes, qlens, c_codes, clens,
                             alphabet=alphabet,
                             interpret=platform.backend() == "cpu")


# ---------------------------------------------------------------------------
# Plain XLA form
# ---------------------------------------------------------------------------


def _down(X, d: int, fill):
    """``X`` shifted ``d`` words toward the high words (axis 0)."""
    head = jnp.full((d,) + X.shape[1:], fill, X.dtype)
    return jnp.concatenate([head, X[:-d]], axis=0)


def _reference_step(VP, VN, Eq, live):
    """One candidate character on ``(W, ...)`` stacked state: the carry
    across words is a Kogge-Stone prefix over (generate, propagate)."""
    words = VP.shape[0]
    Xv = Eq | VN
    t = Eq & VP
    s1 = t + VP
    if words > 1:
        g = _uless(s1, t)
        p = s1 == -1
        d = 1
        while d < words:
            g = g | (p & _down(g, d, False))
            p = p & _down(p, d, False)
            d *= 2
        s = s1 + _down(g, 1, False).astype(jnp.int32)
    else:
        s = s1
    Xh = (s ^ VP) | Eq
    Ph = VN | ~(Xh | VP)
    Mh = VP & Xh
    Ph = (Ph << 1) | _down((Ph >> 31) & 1, 1, 1)
    Mh = (Mh << 1) | _down((Mh >> 31) & 1, 1, 0)
    return (jnp.where(live, Mh | ~(Xv | Ph), VP),
            jnp.where(live, Ph & Xv, VN))


@functools.partial(jax.jit, static_argnames=("alphabet",))
def myers_reference(q_codes, qlens, c_codes, clens, alphabet: int = 256):
    """Distances ``(n_queries, n_cands) int32`` in plain XLA; any word
    count. Arguments as :func:`myers_distances` after :func:`encode`."""
    rows, nq = q_codes.shape
    cand_len, nc = c_codes.shape
    words = rows // 32
    peq = build_peq(q_codes, alphabet)  # (nq, A, W)
    vp0 = jnp.broadcast_to(vp_init(qlens, words).T[:, :, None], (words, nq, nc))
    clens = clens.reshape(1, 1, nc)

    def step(j, carry):
        Eq = jnp.moveaxis(jnp.take(peq, c_codes[j], axis=1), 2, 0)
        return _reference_step(*carry, Eq, j < clens)

    VP, VN = jax.lax.fori_loop(
        0, cand_len, step, (vp0, jnp.zeros((words, nq, nc), jnp.int32)))
    delta = (_popcount(VP & vp0) - _popcount(VN & vp0)).sum(axis=0)
    return clens[0] + delta


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _alpha_ladder(k: int) -> int:
    """Code-space size for ``k`` distinct runes plus the absent code, on a
    dyadic ladder so drifting rune sets reuse compiles."""
    return max(16, 1 << k.bit_length())


def encode(q_t, cands_t, alphabet: int | None):
    """Map characters to PEQ codes. ``alphabet=256``: bytes are their own
    codes. ``alphabet=None`` (UTF-32 runes): rank in the sorted distinct
    query runes, ``A - 1`` for runes no query holds. Returns
    ``(q_codes, c_codes, A)``; needs concrete queries (it reads the rune
    set on the host)."""
    if alphabet is not None:
        return q_t, cands_t, int(alphabet)
    q_np = np.asarray(q_t)
    distinct = np.unique(q_np[q_np >= 0]).astype(np.int32)
    A = _alpha_ladder(len(distinct))
    if len(distinct) == 0:
        return (jnp.asarray(q_t), jnp.full(cands_t.shape, A - 1, jnp.int32), A)
    d = jnp.asarray(distinct)
    q = jnp.asarray(q_t)
    q_codes = jnp.where(q >= 0, jnp.searchsorted(d, q).astype(jnp.int32), -1)
    idx = jnp.clip(jnp.searchsorted(d, cands_t), 0, len(distinct) - 1)
    c_codes = jnp.where(d[idx] == cands_t, idx.astype(jnp.int32), A - 1)
    return q_codes, c_codes, A


def use_kernel(words: int) -> bool:
    """The kernel serves the GPU up to ``MAX_KERNEL_WORDS`` words."""
    return platform.backend() == "gpu" and words <= MAX_KERNEL_WORDS


def myers_distances(
    q_t,  # (rows, n_queries) int32 — query chars, pad -1; rows % 32 == 0
    qlens,  # (n_queries, 1) int32
    cands_t,  # (cand_len, n_cands) int32
    clens,  # (1, n_cands) int32
    alphabet: int | None = 256,
):
    """All-pairs unit-cost edit distances ``(n_queries, n_cands) int32``.

    ``alphabet=256`` asserts all chars are bytes; ``alphabet=None`` takes
    any int32 alphabet (UTF-32 runes). Lanes whose candidate is empty
    return ``qlen``."""
    rows = q_t.shape[0]
    if rows % 32:
        raise ValueError(f"query rows {rows} not a multiple of 32")
    q_codes, c_codes, A = encode(q_t, cands_t, alphabet)
    if use_kernel(rows // 32):
        return myers_kernel(q_codes, qlens, c_codes, clens, A)
    return myers_reference(q_codes, qlens, c_codes, clens, A)
