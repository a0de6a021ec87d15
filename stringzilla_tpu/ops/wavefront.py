"""Anti-diagonal wavefront DP for ONE long pair — the ``diagonal_walker`` tier.

The lane-packed tiers (``myers``, ``similarity.score_batch``) parallelize
ACROSS pairs; a single megabyte-scale pair would use one lane. The reference
solves this with its intra-pair tier: ``diagonal_walker`` sweeps
anti-diagonals, whose cells are mutually independent (reference
``similarities/serial.hpp:533-546,1387``; the ``cross_in_parallel_``
scheduler routes any pair with ``min(len) > L1`` to it,
``serial.hpp:3334-3345``).

Diagonal ``d`` holds cells ``(i, d-i)`` at flat index ``i`` of a 1-D array,
so every step is one dense elementwise pass over the diagonal:

* three rotating diagonals (linear gaps): ``D[d][i]`` needs ``D[d-1][i]``,
  ``D[d-1][i-1]`` (one shift) and ``D[d-2][i-1]`` + substitution;
* the second operand streams through a shift register: ``T[i] = b[d-1-i]``
  advances by one shift + head insert per step, so the substitution
  compare is elementwise;
* boundaries and out-of-range cells are masked with a flat iota; the local
  variant clamps at 0 and max-tracks.

Plain XLA: each diagonal is a handful of fused kernels, so a pair costs
``m + n`` serial steps whatever its width. Memory is O(diagonal). Unit-cost
pairs take the banded tier (:func:`levenshtein_long_pair`), whose steps
walk a fixed band instead of the whole diagonal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .tape import ladder

__all__ = ["wavefront_score", "levenshtein_long_pair", "RING_MIN_CELLS"]

BIG = 1 << 28
#: Pairs whose longest diagonal exceeds this many cells go to the
#: cross-device ring tier when the scope holds more than one device.
RING_MIN_CELLS = 1 << 19
_UNROLL = 8  # diagonals per loop iteration (amortizes the loop's own cost)


def _shift_down(X):
    """``out[i] = X[i-1]``; position 0 receives junk (callers mask it)."""
    return jnp.concatenate([X[:1], X[:-1]])


def _shift_up(X):
    """``out[i] = X[i+1]``; the last position receives junk."""
    return jnp.concatenate([X[1:], X[-1:]])


def _diagonal_loop(step, d0, d_last, carry):
    """``carry = step(d, carry)`` for ``d`` in ``[d0, d_last]``, ``_UNROLL``
    diagonals per iteration; the overshoot of the last iteration is gated
    off."""
    n_iter = (d_last - d0 + _UNROLL) // _UNROLL

    def body(t, c):
        for k in range(_UNROLL):
            d = d0 + t * _UNROLL + k
            keep = d <= d_last
            c = jax.tree.map(lambda new, old: jnp.where(keep, new, old),
                             step(d, c), c)
        return c

    return jax.lax.fori_loop(0, n_iter, body, carry)


@functools.partial(jax.jit, static_argnames=("objective", "locality",
                                             "use_classes", "is_affine"))
def _flat(a, b, mn, costs, table, *, objective: str, locality: str,
          use_classes: bool, is_affine: bool):
    m, n = mn[0], mn[1]
    match, mismatch, gap, extend = costs[0], costs[1], costs[2], costs[3]
    is_min = objective == "min"
    is_local = locality == "local"
    ident = jnp.int32(BIG if is_min else -BIG)
    opt = jnp.minimum if is_min else jnp.maximum
    L = a.shape[0]
    flat = jnp.arange(L, dtype=jnp.int32)

    def boundary(d):
        if is_local:
            return jnp.int32(0)
        if is_affine:
            # a k-gap costs open + extend*(k-1) (reference serial.hpp:77-88)
            return jnp.where(d > 0, gap + extend * (d - 1), 0)
        return gap * d

    def boundary_gap(d):
        # gap-matrix boundary: primary + open + extend (magnitude-padded
        # discard, reference serial.hpp:1139-1146)
        return boundary(d) + gap + extend

    qm1 = _shift_down(a)  # qm1[i] = a[i-1]; index 0 unused (masked)
    if use_classes:
        q_row = jnp.clip(qm1, 0, 31) * 32
        table_flat = table.reshape(-1)

    D2 = jnp.where(flat == 0, 0, ident)  # diagonal 0
    D1 = jnp.where(flat <= 1, boundary(jnp.int32(1)), ident)  # diagonal 1
    I1 = jnp.where(flat <= 1, boundary_gap(jnp.int32(1)), ident)  # horizontal
    J1 = jnp.where(flat <= 1, boundary_gap(jnp.int32(1)), ident)  # vertical
    # shift register entering d=2: T[i] = b[d-1-i] -> T[0]=b[1], T[1]=b[0]
    T0 = jnp.where(flat == 1, b[0], jnp.int32(-1))
    T0 = jnp.where(flat == 0, jnp.where(n > 1, b[1], jnp.int32(-1)), T0)
    best0 = jnp.int32(0)

    def step(d, carry):
        D1, D2, I1, J1, T, best = carry
        # cell (i, d-i) compares a[i-1] with b[d-i-1] = T[i]
        if use_classes:
            sub = jnp.take(table_flat, q_row + jnp.clip(T, 0, 31))
        else:
            sub = jnp.where(qm1 == T, match, mismatch)
        D1s = _shift_down(D1)
        D2s = _shift_down(D2)
        if is_affine:
            # Gotoh on diagonals: the gap matrices need only diagonal d-1
            I_new = opt(D1 + gap, I1 + extend)  # left neighbour (i)
            J_new = opt(D1s + gap, _shift_down(J1) + extend)  # up (i-1)
            cand = opt(D2s + sub, opt(I_new, J_new))
        else:
            cand = opt(opt(D1 + gap, D1s + gap), D2s + sub)
        if is_local:
            cand = opt(cand, 0)
        at_top = flat == 0
        at_left = flat == d
        cand = jnp.where(at_top, jnp.where(d <= n, boundary(d), ident), cand)
        cand = jnp.where(at_left, jnp.where(d <= m, boundary(d), ident), cand)
        valid = (flat <= jnp.minimum(d, m)) & (flat >= jnp.maximum(d - n, 0))
        cand = jnp.where(valid, cand, ident)
        if is_affine:
            I_new = jnp.where(at_top | at_left, boundary_gap(d), I_new)
            J_new = jnp.where(at_top | at_left, boundary_gap(d), J_new)
            I1 = jnp.where(valid, I_new, ident)
            J1 = jnp.where(valid, J_new, ident)
        if is_local:
            inner = valid & (flat >= 1) & (flat <= m) & (d - flat >= 1)
            masked = jnp.where(inner, cand, ident)
            best = opt(best, jnp.min(masked) if is_min else jnp.max(masked))
        # advance the b shift register: T'[i] = b[d-i]; T'[0] = b[d]
        bd = jnp.where(d < n, b[jnp.minimum(d, L - 1)], jnp.int32(-1))
        T = jnp.where(flat == 0, bd, _shift_down(T))
        return cand, D1, I1, J1, T, best

    D1, _, _, _, _, best = _diagonal_loop(step, 2, m + n,
                                          (D1, D2, I1, J1, T0, best0))
    if is_local:
        return best
    return D1[m]  # D[m+n][m]: flat index m of the last diagonal


def wavefront_score(
    a: np.ndarray,  # uint8/int32 chars (or class ids when `table` given)
    b: np.ndarray,
    match: int = 0,
    mismatch: int = 1,
    gap: int = 1,
    objective: str = "min",
    locality: str = "global",
    table: np.ndarray | None = None,  # 32x32 class costs; a/b are class ids
    extend: int | None = None,  # affine: `gap` is OPEN, `extend` extends
) -> int:
    """Score ONE (possibly huge) pair with the anti-diagonal wavefront.
    Uniform substitution costs — or a 32x32 class-cost table (NW/SW style)
    with ``a``/``b`` pre-mapped to class ids. Linear gaps, or Gotoh affine
    when ``extend`` is given (k-gap costs ``gap + extend*(k-1)``)."""
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    m, n = len(a), len(b)
    is_affine = extend is not None
    if m == 0 or n == 0:
        if locality == "local":
            return 0
        k = m + n
        if is_affine:
            return gap + extend * (k - 1) if k else 0
        return k * gap
    L = ladder(-(-max(m + 1, n) // 128)) * 128

    def pack(x):
        buf = np.full(L, -2, dtype=np.int32)  # -2 differs from T's pad (-1)
        buf[: len(x)] = x
        return jnp.asarray(buf)

    costs = np.array([match, mismatch, gap, extend if is_affine else 0],
                     dtype=np.int32)
    tab = np.zeros((32, 32), np.int32) if table is None else np.asarray(
        table, dtype=np.int32)
    out = _flat(pack(a), pack(b), jnp.asarray(np.array([m, n], np.int32)),
                jnp.asarray(costs), jnp.asarray(tab), objective=objective,
                locality=locality, use_classes=table is not None,
                is_affine=is_affine)
    return int(out)


# ---------------------------------------------------------------------------
# Banded tier (unit costs, global, min) — Ukkonen band doubling
# ---------------------------------------------------------------------------
#
# When the true distance d is small (near-duplicate long pairs), every
# optimal path stays inside the band |i-j| <= d, so a band of half-width
# k >= d is EXACT by Ukkonen's lemma: any path leaving the band costs > k,
# so a banded result <= k equals the unbanded distance. The ladder doubles
# k until that check passes.
#
# Band coordinates: on diagonal d, live cells i ∈ [lo(d), lo(d)+U) with
# lo(d) = max(0, ceil((d-k)/2)); cell i sits at band index u = i - lo(d).
# lo advances by 0/1 per step, so neighbour reads are ±1 shifts selected by
# the per-step delta. The DP state shrinks from O(min(m,n)) to O(k).
#
# Reference analog: bounded Levenshtein (``similarities/serial.hpp``'s
# bound parameter); the band doubling is this repo's own.


@functools.partial(jax.jit, static_argnames=("U",))
def _banded(a, b, q0, t0, mnk, *, U: int):
    """The WHOLE doubling ladder in one program: the half-width k is a
    runtime scalar, rung state lives in a fixed U-cell band sized for kmax,
    and each rung aborts once the band minimum exceeds k. The abort step
    also prices the next rung: frontier minima grow roughly linearly in
    walked diagonals for scattered-edit pairs, so k * tmax / t_abort
    estimates the true distance and the ladder jumps to the rung that will
    certify it. Returns ``[result, status]``, status 1 = certified,
    2 = distance > kmax."""
    m, n, k0, kmax = mnk[0], mnk[1], mnk[2], mnk[3]
    La = a.shape[0]
    ident = jnp.int32(BIG)
    flat = jnp.arange(U, dtype=jnp.int32)
    tmax = (m + n - 1 + 3) // 4  # 4-diagonal blocks to walk

    def walk(k):
        def lo_of(d):
            return jnp.maximum(0, (d - k + 1) // 2)

        def step(d, carry):
            D1, D2, T, Q = carry
            lo = lo_of(d)
            d1 = lo - lo_of(d - 1)  # 0/1
            d2 = lo - lo_of(d - 2)  # 0/1
            # band coords: D[d-1][i] = D1[u + d1], D[d-1][i-1] = D1[u+d1-1],
            # D[d-2][i-1] = D2[u + d2 - 1]
            D1u = jnp.where(flat == U - 1, ident, _shift_up(D1))
            D1d = jnp.where(flat == 0, ident, _shift_down(D1))
            D2d = jnp.where(flat == 0, ident, _shift_down(D2))
            nb_same = jnp.where(d1 == 0, D1, D1u)
            nb_diag = jnp.where(d1 == 0, D1d, D1)
            nb_sub = jnp.where(d2 == 0, D2d, D2)
            sub = jnp.where(Q == T, 0, 1)
            cand = jnp.minimum(jnp.minimum(nb_same, nb_diag) + 1, nb_sub + sub)
            i = flat + lo
            cand = jnp.where((i == 0) & (d <= n), d, cand)
            cand = jnp.where((i == d) & (d <= m), d, cand)
            j = d - i
            valid = ((i <= jnp.minimum(d, m)) & (i >= jnp.maximum(d - n, 0))
                     & (jnp.abs(i - j) <= k))
            cand = jnp.where(valid, cand, ident)
            # advance the streaming registers to d+1: exactly ONE new char
            # enters the band — an `a` char at Q's tail when the band head
            # advances, else a `b` char at T's head.
            lo1 = lo_of(d + 1)
            is_a = (lo1 - lo) == 1
            idx = jnp.where(is_a, lo1 - 2 + U, d - lo1)
            limit = jnp.where(is_a, m, n)
            src = jnp.where(is_a, a[jnp.clip(idx, 0, La - 1)],
                            b[jnp.clip(idx, 0, La - 1)])
            v = jnp.where((idx >= 0) & (idx < limit), src,
                          jnp.where(is_a, jnp.int32(-2), jnp.int32(-1)))
            # T'[u] = b[d-u-lo(d+1)]: unchanged when a enters, else shifts
            T = jnp.where(is_a, T, jnp.where(flat == 0, v, _shift_down(T)))
            # Q'[u] = a[u+lo(d+1)-1]: shifts when a enters, else unchanged
            Q = jnp.where(is_a, jnp.where(flat == U - 1, v, _shift_up(Q)), Q)
            return cand, D1, T, Q

        def step4(t, carry):
            for jj in range(4):
                d = 2 + t * 4 + jj
                keep = d <= m + n
                carry = tuple(jnp.where(keep, nv, ov)
                              for nv, ov in zip(step(d, carry), carry))
            return carry

        # Early exit: every new frontier value is >= the min over the two
        # previous frontiers (unit costs), so once min(D1, D2) exceeds k the
        # distance provably exceeds k; checked once per 4-diagonal block.
        # (Unrolling more blocks per check makes XLA's compile time grow
        # superlinearly.)
        def cond(carry):
            t, D1, D2, T, Q, bmin = carry
            return (t < tmax) & (bmin <= k)

        def body(carry):
            t, D1, D2, T, Q, bmin = carry
            D1, D2, T, Q = step4(t, (D1, D2, T, Q))
            return (t + 1, D1, D2, T, Q,
                    jnp.minimum(jnp.min(D1), jnp.min(D2)))

        # entering d=2: lo(2)=0 (k >= 2), so band coords == flat coords
        D2 = jnp.where(flat == 0, 0, ident)
        D1 = jnp.where(flat <= 1, 1, ident)
        t, D1, D2, T, Q, bmin = jax.lax.while_loop(
            cond, body, (jnp.int32(0), D1, D2, t0, q0, jnp.int32(0)))
        # D[m+n][m] sits at band index m - lo(m+n)
        res = D1[jnp.clip(m - lo_of(m + n), 0, U - 1)]
        return res, bmin, t

    def pow2ceil_from(base, lo):
        return jax.lax.while_loop(lambda p: p < lo, lambda p: p * 2, base)

    def rung_body(carry):
        k, _, _ = carry
        res, bmin, t = walk(k)
        aborted = bmin > k
        ok = (~aborted) & (res <= k)
        # abort -> abort-step estimate (+25% headroom); completed-but-over
        # -> res is a true upper bound (restricting paths only over-counts)
        est_abort = k * tmax // jnp.maximum(t, 1)
        est = jnp.where(aborted, est_abort + est_abort // 4, res)
        knext = jnp.minimum(pow2ceil_from(2 * k, jnp.minimum(est, kmax)), kmax)
        status = jnp.where(ok, 1, jnp.where(k >= kmax, 2, 0))
        return (jnp.where(status == 0, knext, k),
                jnp.where(ok, res, jnp.int32(0)), status)

    _, res, status = jax.lax.while_loop(
        lambda c: c[2] == 0, rung_body, (k0, jnp.int32(0), jnp.int32(0)))
    return jnp.stack([res, status])


#: Band cells per step: the band tier certifies distances up to
#: ``(BAND_CELLS - 2) // 2``; larger ones take the flat wavefront.
BAND_CELLS = 4096


def levenshtein_long_pair(a: np.ndarray, b: np.ndarray, k0: int = 64) -> int:
    """Exact Levenshtein distance of ONE long pair via Ukkonen band
    doubling over the anti-diagonal wavefront, the whole ladder in one
    device program. Near-duplicate pairs finish in O((m+n) * d) cell work
    instead of O((m+n) * min(m,n)). Falls back to the flat wavefront when
    the band cannot be narrower than the diagonal or d > kmax."""
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return m + n
    rows_flat = -(-max(-(-max(m + 1, n) // 128), 8) // 8) * 8
    U = min(BAND_CELLS, ((rows_flat - 8) // 8) * 8 * 128)
    if U < 1024:
        return wavefront_score(a, b)
    kmax = (U - 2) // 2
    k = max(k0, 2)
    while k < abs(m - n):  # the band must contain the final cell
        k *= 2
    if k > kmax:
        return wavefront_score(a, b)
    La = ladder(-(-max(m, n) // 128)) * 128
    a_pad = np.full(La, -2, np.int32)
    a_pad[:m] = a
    b_pad = np.full(La, -2, np.int32)
    b_pad[:n] = b
    # streaming registers entering d=2 (lo(2)=0): Q[u] = a[u-1], T per flat
    q0 = np.full(U, -2, dtype=np.int32)
    q0[1:] = np.pad(a, (0, max(0, U - 1 - m)), constant_values=-2)[: U - 1]
    t0 = np.full(U, -1, dtype=np.int32)
    t0[0] = b[1] if n > 1 else -1
    t0[1] = b[0]
    out = np.asarray(_banded(jnp.asarray(a_pad), jnp.asarray(b_pad),
                             jnp.asarray(q0), jnp.asarray(t0),
                             jnp.asarray(np.array([m, n, k, kmax], np.int32)),
                             U=U))
    if int(out[1]) == 1:
        return int(out[0])
    return wavefront_score(a, b)  # d > kmax: banding cannot help
