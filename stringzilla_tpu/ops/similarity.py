"""Batched sequence-similarity DP — the lane-packed column walk.

Re-design of the reference's similarity engines
(``include/stringzillas/similarities/serial.hpp``). The reference walks the DP
matrix anti-diagonally with per-ISA SIMD ``tile_scorer`` specializations
(reference ``serial.hpp:496-511``); here the walk is **lane-packed by
columns**:

* candidates are packed across lanes (one candidate per lane, the analog of
  ``candidate_lane_walker``, reference ``serial.hpp:599-613``);
* one query is shared by the whole block and laid down the row axis;
* the DP advances one *candidate character* per step, updating a whole
  ``(rows, lanes)`` column tile of cells at once;
* the sequential within-column dependency ``new[i] = opt(a[i], new[i-1] + gap)``
  is linearized exactly as a min-plus (max-plus) prefix scan::

      new[i] = opt_{k<=i} ( a[k] + gap * (i - k) )
             = cum_opt( a - gap*iota )[i] + gap*i

  computed with O(log rows) shift+opt passes — every step is dense
  elementwise work that XLA fuses.

Exact recurrences, boundary values, and the local-alignment clamp mirror the
reference ``tile_scorer`` specializations bit-for-bit (global linear:
``serial.hpp:853-969``; local linear: ``:971-1089``; global affine (Gotoh):
``:1091-1238``; local affine: ``:1240-1386``). All arithmetic is exact int32.

The 32x32 class-cost substitution (``error_costs_32x32_t``,
``serial.hpp:118-189``) is two integer gathers: the per-query cost slice
``Sq = table[q_class]`` is built once, and each step's cost column is
``Sq[:, c_class_j]``.

:func:`score_batch` scores a whole (queries x candidates) bucket in one jit,
the queries batched with ``vmap`` over :func:`score_block`.

Shape conventions (everything 2D):

* ``q_ext``:  ``(rows, 1)``   query chars shifted down by one; row 0 unused
* ``c_row``:  ``(1, lanes)``  current candidate character per lane
* ``clens``:  ``(1, lanes)``  candidate lengths
* ``D/I``:    ``(rows, lanes)`` int32 DP columns
* results:    ``(1, lanes)`` int32
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "UniformCosts",
    "ClassCosts",
    "LinearGaps",
    "AffineGaps",
    "SimilarityConfig",
    "score_block",
    "score_batch",
    "BIG",
]

# Large-but-overflow-safe sentinel: adding gap*rows or cost magnitudes on top of
# it stays far below int32 limits (mirrors the reference's "higher magnitude is
# equivalent to discarding" trick, serial.hpp:1139-1146).
BIG = 1 << 28


@dataclasses.dataclass(frozen=True)
class UniformCosts:
    """Match/mismatch substitution costs (``uniform_substitution_costs_t``,
    reference ``serial.hpp:102-111``)."""

    match: int = 0
    mismatch: int = 1


@dataclasses.dataclass(frozen=True)
class ClassCosts:
    """256→32-class map + 32x32 signed cost table (``error_costs_32x32_t``,
    reference ``serial.hpp:118-189``). Stored as nested tuples so the config
    stays hashable for jit specialization keys."""

    byte_to_class: tuple  # length-256 tuple of ints
    table: tuple  # 32x32 nested tuple of ints

    @classmethod
    def from_arrays(cls, byte_to_class, table) -> "ClassCosts":
        b = np.asarray(byte_to_class, dtype=np.uint8)
        t = np.asarray(table, dtype=np.int32)
        if b.shape != (256,) or t.shape != (32, 32):
            raise ValueError("byte_to_class must be [256], table must be [32,32]")
        return cls(
            byte_to_class=tuple(int(x) for x in b),
            table=tuple(tuple(int(x) for x in row) for row in t),
        )

    def byte_to_class_np(self) -> np.ndarray:
        return np.asarray(self.byte_to_class, dtype=np.uint8)

    def table_np(self) -> np.ndarray:
        return np.asarray(self.table, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class LinearGaps:
    """``linear_gap_costs_t`` (reference ``serial.hpp:70-75``)."""

    open_or_extend: int = 1


@dataclasses.dataclass(frozen=True)
class AffineGaps:
    """``affine_gap_costs_t`` — Gotoh three-matrix gaps; a run of k gaps costs
    ``open + extend*(k-1)`` (reference ``serial.hpp:77-88,1135-1146``)."""

    open: int = 1
    extend: int = 1


@dataclasses.dataclass(frozen=True)
class SimilarityConfig:
    """Static configuration — one jit specialization per value."""

    objective: Literal["min", "max"] = "min"
    locality: Literal["global", "local"] = "global"
    gaps: LinearGaps | AffineGaps = LinearGaps(1)
    costs: UniformCosts | ClassCosts = UniformCosts(0, 1)

    @property
    def is_affine(self) -> bool:
        return isinstance(self.gaps, AffineGaps)

    @property
    def is_local(self) -> bool:
        return self.locality == "local"

    @property
    def uses_classes(self) -> bool:
        return isinstance(self.costs, ClassCosts)

    def opt(self, a, b):
        return jnp.minimum(a, b) if self.objective == "min" else jnp.maximum(a, b)

    @property
    def ident(self) -> int:
        """Identity for opt-reductions (discard sentinel)."""
        return BIG if self.objective == "min" else -BIG

    def reduce_rows(self, x):
        fn = jnp.min if self.objective == "min" else jnp.max
        return fn(x, axis=0, keepdims=True)


def _shift_down(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """``y[i] = x[i-d]`` along axis 0, filling rows ``< d`` (static shift:
    a roll + select)."""
    rolled = jnp.roll(x, d, axis=0)
    rows = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
    return jnp.where(rows < d, fill, rolled)


_SCAN_BLOCK = 64  # two-level scan block


def _cum_opt_down(t: jnp.ndarray, cfg: SimilarityConfig) -> jnp.ndarray:
    """Inclusive running min/max along axis 0.

    min/max are associative and exact on int32, so these parallel scans are
    bit-identical to the sequential recurrence they replace.

    Tall tiles use a two-level blocked scan: log2(B) block-masked passes over
    the full tile, a doubling scan over the (rows/B, lanes) block-carry tile
    (~B× cheaper per pass), and one combine pass — ~7 full-tile passes at
    rows=1024 instead of 11."""
    rows, lanes = t.shape
    B = _SCAN_BLOCK
    if rows <= 2 * B:
        d = 1
        while d < rows:
            t = cfg.opt(t, _shift_down(t, d, cfg.ident))
            d *= 2
        return t
    nb = -(-rows // B)
    pad = nb * B - rows
    if pad:
        t = jnp.concatenate(
            [t, jnp.full((pad, lanes), cfg.ident, t.dtype)], axis=0)
    in_block = jax.lax.broadcasted_iota(jnp.int32, t.shape, 0) & (B - 1)
    d = 1
    while d < B:
        rolled = jnp.roll(t, d, axis=0)
        t = cfg.opt(t, jnp.where(in_block < d, cfg.ident, rolled))
        d *= 2
    carries = t.reshape(nb, B, lanes)[:, B - 1, :]  # per-block inclusive tail
    d = 1
    while d < nb:
        carries = cfg.opt(carries, _shift_down(carries, d, cfg.ident))
        d *= 2
    prev_carry = _shift_down(carries, 1, cfg.ident)  # exclusive across blocks
    full = jnp.broadcast_to(prev_carry[:, None, :], (nb, B, lanes))
    t = cfg.opt(t, full.reshape(nb * B, lanes))
    return t[:rows] if pad else t


def _chain_scan(a: jnp.ndarray, gap: int, cfg: SimilarityConfig) -> jnp.ndarray:
    """Solve ``new[i] = opt(a[i], new[i-1] + gap)`` exactly via prefix scan."""
    rows_iota = jax.lax.broadcasted_iota(jnp.int32, a.shape, 0)
    t = a - gap * rows_iota
    return _cum_opt_down(t, cfg) + gap * rows_iota


def _boundary_primary(j, cfg: SimilarityConfig):
    """Top-row/left-column boundary D[0][j] (reference ``init_score``: linear
    ``serial.hpp:912-914``; affine ``:1134-1137``; local: 0)."""
    if cfg.is_local:
        return jnp.int32(0) * j
    if cfg.is_affine:
        o, e = cfg.gaps.open, cfg.gaps.extend
        return jnp.where(j > 0, o + e * (j - 1), 0).astype(jnp.int32)
    return (cfg.gaps.open_or_extend * j).astype(jnp.int32)


def _boundary_gap(j, cfg: SimilarityConfig):
    """Gap-matrix boundary (reference ``init_gap``, ``serial.hpp:1139-1146``:
    primary boundary plus ``open+extend`` — a magnitude-padded discard)."""
    assert cfg.is_affine
    o, e = cfg.gaps.open, cfg.gaps.extend
    return (_boundary_primary(j, cfg) + (o + e)).astype(jnp.int32)


def _substitution_column(q_ext, c_row, cfg: SimilarityConfig, sq=None):
    """Cost column ``sub[i, lane] = cost(q[i-1], c_row[lane])`` of shape
    ``(rows, lanes)``. Row 0 is garbage (overwritten by the boundary)."""
    if cfg.uses_classes:
        # Integer gather from the per-query cost slice: sq is (rows, 32)
        # int32, column c of it is the cost of class c against every row.
        return jnp.take(sq, c_row.reshape(-1).astype(jnp.int32), axis=1)
    match, mismatch = cfg.costs.match, cfg.costs.mismatch
    eq = q_ext.astype(jnp.int32) == c_row.astype(jnp.int32)
    return jnp.where(eq, jnp.int32(match), jnp.int32(mismatch))


def build_sq(q_ext: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """Per-query cost slice ``Sq[i, c] = table[q_class[i], c]`` as int32
    ``(rows, 32)`` — one row gather (``q_ext`` is already class-mapped
    via ``byte_to_class``)."""
    q = jnp.clip(q_ext.reshape(-1).astype(jnp.int32), 0, 31)
    return jnp.take(table.astype(jnp.int32), q, axis=0)


def _column_step_linear(D, j, c_row, q_ext, clens, cfg: SimilarityConfig,
                        sq=None, sub=None):
    g = cfg.gaps.open_or_extend
    if sub is None:
        sub = _substitution_column(q_ext, c_row, cfg, sq)
    Dm1 = _shift_down(D, 1, cfg.ident)
    # a[i] = opt(horizontal D[i][j-1]+g, diagonal D[i-1][j-1]+sub, (0 if local))
    a = cfg.opt(D + g, Dm1 + sub)
    if cfg.is_local:
        a = cfg.opt(a, 0)
    # Row 0 carries the boundary value and seeds the vertical chain.
    rows = jax.lax.broadcasted_iota(jnp.int32, a.shape, 0)
    a = jnp.where(rows == 0, _boundary_primary(j, cfg), a)
    D_new = _chain_scan(a, g, cfg)
    # Freeze lanes whose candidate already ended: their column stays final.
    live = j <= clens
    return jnp.where(live, D_new, D)


def _column_step_affine(D, I, j, c_row, q_ext, clens, cfg: SimilarityConfig,
                        sq=None, sub=None):
    o, e = cfg.gaps.open, cfg.gaps.extend
    if sub is None:
        sub = _substitution_column(q_ext, c_row, cfg, sq)
    rows = jax.lax.broadcasted_iota(jnp.int32, D.shape, 0)

    # Horizontal gap matrix (propagates along j only): I[i][j] =
    # opt(D[i][j-1]+open, I[i][j-1]+extend); row 0 takes the boundary init_gap.
    I_new = cfg.opt(D + o, I + e)
    I_new = jnp.where(rows == 0, _boundary_gap(j, cfg), I_new)

    # a[i] = chain-free part of the cell: diagonal + horizontal (+ local reset).
    Dm1 = _shift_down(D, 1, cfg.ident)
    a = cfg.opt(Dm1 + sub, I_new)
    if cfg.is_local:
        a = cfg.opt(a, 0)
    a = jnp.where(rows == 0, _boundary_primary(j, cfg), a)

    # Vertical gap matrix (within-column): Dd[i] = opt(D[i-1]+open, Dd[i-1]+ext)
    # with D[i-1] = opt(a[i-1], Dd[i-1]) folds to the exact linear chain
    #   Dd[i] = opt(a[i-1]+open, Dd[i-1] + opt(open, extend)).
    g_chain = min(o, e) if cfg.objective == "min" else max(o, e)
    b = _shift_down(a, 1, cfg.ident) + o
    b = jnp.where(rows == 0, _boundary_gap(j, cfg), b)
    Dd = _chain_scan(b, g_chain, cfg)

    D_new = cfg.opt(a, Dd)
    live = j <= clens
    return jnp.where(live, D_new, D), jnp.where(live, I_new, I)


def init_columns(rows: int, lanes: int, cfg: SimilarityConfig):
    """Column state at j=0: the left DP boundary."""
    i = jax.lax.broadcasted_iota(jnp.int32, (rows, lanes), 0)
    D0 = _boundary_primary(i, cfg)
    if not cfg.is_affine:
        return (D0,)
    return (D0, _boundary_gap(i, cfg))


def column_step(state, j, c_row, q_ext, clens, cfg: SimilarityConfig, sq=None,
                sub=None):
    """Advance the lane-packed DP by one candidate character.

    ``state`` is ``(D,)`` for linear gaps or ``(D, I)`` for affine. Returns the
    new state tuple. All arrays follow the module-level 2D shape conventions.
    ``sub`` optionally supplies the precomputed substitution column.
    """
    if cfg.is_affine:
        D, I = state
        return _column_step_affine(D, I, j, c_row, q_ext, clens, cfg, sq,
                                   sub=sub)
    (D,) = state
    return (_column_step_linear(D, j, c_row, q_ext, clens, cfg, sq, sub=sub),)


def extract_result(D, qlen, clens, cfg: SimilarityConfig, best=None):
    """Global: D[qlen][clen] per lane (the column freezes at each lane's final
    j). Local: reduce the elementwise running best over valid rows, seeded at
    0 (reference ``serial.hpp:1016,1327-1337``). Returns ``(1, lanes) int32``."""
    rows = jax.lax.broadcasted_iota(jnp.int32, D.shape, 0)
    if cfg.is_local:
        valid = (rows >= 1) & (rows <= qlen)
        masked = jnp.where(valid, best, cfg.ident)
        return cfg.opt(cfg.reduce_rows(masked), jnp.int32(0))
    masked = jnp.where(rows == qlen, D, cfg.ident)
    return cfg.reduce_rows(masked)


def update_best(best, D, cfg: SimilarityConfig):
    """Accumulate the local-alignment optimum ELEMENTWISE — one dense opt per
    column step instead of a cross-row reduction; row-validity and the 0 seed
    are applied once in ``extract_result``. Exact: dead lanes' columns freeze,
    so re-accumulating them is idempotent under min/max."""
    return cfg.opt(best, D)


# ---------------------------------------------------------------------------
# Block and batch drivers
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg",))
def score_block(
    q_ext: jnp.ndarray,  # (rows, 1) int32, row 0 = padding, row i = q[i-1]
    qlen: jnp.ndarray,  # () int32
    cands_t: jnp.ndarray,  # (Lc, lanes) int32, transposed candidate block
    clens: jnp.ndarray,  # (1, lanes) int32
    cfg: SimilarityConfig,
    table: jnp.ndarray | None = None,  # (32, 32) int32 when cfg uses classes
) -> jnp.ndarray:
    """Score one query against a lane-packed candidate block. Returns
    ``(1, lanes) int32``."""
    rows = q_ext.shape[0]
    Lc, lanes = cands_t.shape
    sq = build_sq(q_ext, table) if cfg.uses_classes else None
    state = init_columns(rows, lanes, cfg)
    best0 = jnp.zeros((rows, lanes), jnp.int32)

    def body(carry, j):
        state, best = carry
        c_row = jax.lax.dynamic_slice_in_dim(cands_t, j - 1, 1, axis=0)
        state = column_step(state, j, c_row, q_ext, clens, cfg, sq)
        if cfg.is_local:
            best = update_best(best, state[0], cfg)
        return (state, best), None

    (state, best), _ = jax.lax.scan(body, (state, best0), jnp.arange(1, Lc + 1))
    return extract_result(state[0], qlen, clens, cfg, best)


@partial(jax.jit, static_argnames=("cfg",))
def _score_chunk(q_ext_t, qlens, cands_t, clens, cfg, table=None):
    def one(q, qlen):
        return score_block(q[:, None], qlen, cands_t, clens, cfg, table)[0]

    return jax.vmap(one)(q_ext_t.T, qlens.reshape(-1))


#: Cells of one (queries x rows x lanes) DP column held at once; bigger
#: buckets run in query chunks.
_BATCH_CELLS = 1 << 26


def score_batch(
    q_ext_t: jnp.ndarray,  # (rows, n_queries) int32, row 0 = padding
    qlens: jnp.ndarray,  # (n_queries, 1) int32
    cands_t: jnp.ndarray,  # (Lc, n_cands) int32, candidates across lanes
    clens: jnp.ndarray,  # (1, n_cands) int32
    cfg: SimilarityConfig,
    table: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """All-pairs scores ``(n_queries, n_cands) int32`` for one shape bucket:
    every query of a chunk advances together, one jit per chunk shape."""
    rows, nq = q_ext_t.shape
    nc = cands_t.shape[1]
    chunk = max(1, _BATCH_CELLS // max(rows * nc, 1))
    chunk = min(1 << (chunk.bit_length() - 1), nq)
    if chunk >= nq:
        return _score_chunk(q_ext_t, qlens, cands_t, clens, cfg, table)
    pad = (-nq) % chunk
    if pad:
        q_ext_t = jnp.pad(q_ext_t, ((0, 0), (0, pad)))
        qlens = jnp.pad(qlens, ((0, pad), (0, 0)))
    parts = [_score_chunk(q_ext_t[:, s:s + chunk], qlens[s:s + chunk],
                          cands_t, clens, cfg, table)
             for s in range(0, nq + pad, chunk)]
    return jnp.concatenate(parts, axis=0)[:nq]
