"""Cross-chip wavefront: ONE pair's DP matrix sharded over the mesh.

The single-device wavefront (``ops/wavefront``) walks one pair's diagonals
serially on one device. The reference's GPU tier passes tile boundaries
through a global ``row_frontier`` (reference
``similarities/cuda.cuh:708-749``); the multi-device form maps that frontier
exchange onto **``ppermute`` along the mesh ring**:

* the first operand's rows are split into D contiguous chunks (one per
  device); the second operand is processed in column blocks of C;
* macro-step t: device d computes tile ``(rows d, column block t-d)`` — a
  systolic pipeline, D stages deep;
* each tile consumes the bottom rows of the chunk above (the D — and for
  affine also the vertical-gap F — frontier, received last step)
  and its own right columns (kept local), and emits its bottoms to the
  next device;
* inside a tile, every column is one dense vector step over the chunk's
  rows: the within-column dependency (the D chain for linear gaps, the
  Gotoh F chain for affine) is linearized with the same exact min/max
  prefix scan as the lane-packed kernels (``ops/similarity._chain_scan``).

Full config space of the single-chip tiers: uniform OR 32×32 class-cost
substitution (an integer gather per chunk), linear OR Gotoh affine gaps
(k-gap = open + extend·(k-1)), global OR local (Smith-Waterman clamp +
running best) alignment, min or max objective. Exact int32; validated
against the Gotoh/Wagner-Fischer oracles on the virtual multi-device CPU
mesh — the same shard_map program runs over NVLink on several GPUs.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["ring_wavefront_score"]

BIG = 1 << 28


def _chain_scan(base: jnp.ndarray, gap, is_min: bool) -> jnp.ndarray:
    """Exact solve of ``new[i] = opt(base[i], new[i-1] + gap)`` (1-D)."""
    n = base.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    t = base - gap * iota
    ident = jnp.int32(BIG if is_min else -BIG)
    opt = jnp.minimum if is_min else jnp.maximum
    d = 1
    while d < n:
        shifted = jnp.where(iota >= d, jnp.roll(t, d), ident)
        t = opt(t, shifted)
        d *= 2
    return t + gap * iota


def _build_ring(mesh: Mesh, mb: int, C: int, NB: int, match: int,
                mismatch: int, open_: int, extend: int, is_min: bool,
                is_affine: bool, is_local: bool, use_table: bool):
    D = mesh.devices.size
    opt = jnp.minimum if is_min else jnp.maximum
    ident = jnp.int32(BIG if is_min else -BIG)

    def gbound(k):
        # boundary of a k-long gap; affine: open + extend*(k-1)
        if is_affine:
            return jnp.where(k > 0, open_ + extend * (k - 1), 0)
        return open_ * k

    ext = extend if is_affine else open_

    def tile(sub_tile, left_D, left_E, top_D, top_F, corner):
        """One (mb x C) tile.

        sub_tile: (C, mb) substitution costs; left_D/left_E: (mb,) previous
        column's D and E (horizontal-gap) values; top_D/top_F: (C,) frontier
        rows from the device above; corner: D at (row_base, col_base).
        Returns (right_D, right_E, bottom_D, bottom_F, cols)."""

        def col_step(carry, inp):
            Dcol, Ecol, prev_top = carry
            sub, top_d, top_f = inp
            if is_affine:
                E_new = opt(Ecol + extend, Dcol + open_)
            else:
                E_new = Dcol + open_  # linear: horizontal step collapses
            diag = jnp.concatenate([prev_top[None], Dcol[:-1]])
            D0 = opt(diag + sub, E_new)
            if is_local:
                D0 = opt(D0, 0)
            # vertical chain: F[i] = opt(F[i-1]+ext, D[i-1]+open); seeded by
            # the frontier's F/D (re-opening never improves for min costs>=0
            # / max penalties<=0, so D0 stands in for D exactly)
            up_D = jnp.concatenate([top_d[None], D0[:-1]])
            base = up_D + open_
            base = base.at[0].set(opt(base[0], top_f + extend)
                                  if is_affine else base[0])
            F = _chain_scan(base, ext, is_min)
            D_new = opt(D0, F)
            if is_local:
                D_new = opt(D_new, 0)
            return (D_new, E_new, top_d), (D_new, F)

        (Dcol, Ecol, _), (cols, Fcols) = jax.lax.scan(
            col_step, (left_D, left_E, corner),
            (sub_tile, top_D, top_F))
        # cols: (C, mb); bottoms = last row of every column
        return Dcol, Ecol, cols[:, -1], Fcols[:, -1], cols

    def run(a_chunk, b_full, mn, table):
        d = jax.lax.axis_index("data")
        m, n = mn[0], mn[1]
        row_base = d * mb  # global row index of the chunk's first row - 1
        i_local = jnp.arange(mb, dtype=jnp.int32)

        a_chunk = a_chunk.astype(jnp.int32)
        b_full = b_full.astype(jnp.int32)

        if use_table:
            # rowcost[i, c] = table[a_class[i], c], gathered once per device
            rowcost = jnp.take(table.astype(jnp.int32),
                               jnp.clip(a_chunk, 0, 31), axis=0)

        if is_local:
            left0_D = jnp.zeros(mb, jnp.int32)
            left0_E = jnp.full(mb, ident // 2, jnp.int32)
            corner0 = jnp.int32(0)
        else:
            left0_D = gbound(row_base + 1 + i_local).astype(jnp.int32)
            left0_E = left0_D + open_ + (extend if is_affine else open_)
            corner0 = gbound(row_base).astype(jnp.int32)
        state = dict(
            left_D=left0_D, left_E=left0_E, corner=corner0,
            frontier_D=jnp.zeros(C, jnp.int32),
            frontier_F=jnp.zeros(C, jnp.int32),
            res_col=jnp.zeros(mb, jnp.int32),
            best=jnp.int32(0),
        )

        def macro(state, t):
            j_b = t - d
            active = (j_b >= 0) & (j_b < NB)
            jb = jnp.clip(j_b, 0, NB - 1)
            col_base = jb * C  # global col of first column - 1
            b_block = jax.lax.dynamic_slice(b_full, (col_base,), (C,))
            cols_iota = col_base + 1 + jnp.arange(C, dtype=jnp.int32)
            if is_local:
                top0_D = jnp.zeros(C, jnp.int32)
                top0_F = jnp.full(C, ident // 2, jnp.int32)
                corner_in = jnp.int32(0)
            else:
                top0_D = gbound(cols_iota).astype(jnp.int32)
                top0_F = top0_D + open_ + (extend if is_affine else open_)
                corner_in = gbound(col_base).astype(jnp.int32)
            top_D = jnp.where(d == 0, top0_D, state["frontier_D"])
            top_F = jnp.where(d == 0, top0_F, state["frontier_F"])
            corner = jnp.where(d == 0, corner_in, state["corner"])

            if use_table:
                bcls = jnp.clip(b_block, 0, 31)
                sub_tile = rowcost[:, bcls].T  # (C, mb)
            else:
                sub_tile = jnp.where(a_chunk[None, :] == b_block[:, None],
                                     jnp.int32(match), jnp.int32(mismatch))

            right_D, right_E, bottom_D, bottom_F, cols = tile(
                sub_tile, state["left_D"], state["left_E"], top_D, top_F,
                corner)
            # capture the column holding global col n (for global alignment)
            has_n = active & (col_base < n) & (n <= col_base + C)
            col_n = jnp.sum(jnp.where((cols_iota == n)[:, None], cols, 0), axis=0)
            res_col = jnp.where(has_n, col_n, state["res_col"])
            # local: best over the tile's VALID cells
            valid = ((i_local[None, :] + row_base + 1 <= m)
                     & (cols_iota[:, None] <= n))
            tile_best = (jnp.max(jnp.where(valid & active, cols, 0))
                         if not is_min else jnp.int32(0))
            new_state = dict(
                left_D=jnp.where(active, right_D, state["left_D"]),
                left_E=jnp.where(active, right_E, state["left_E"]),
                corner=jnp.where(active, top_D[C - 1], state["corner"]),
                frontier_D=jax.lax.ppermute(
                    jnp.where(active, bottom_D, state["frontier_D"]),
                    "data", [(k, (k + 1) % D) for k in range(D)]),
                frontier_F=jax.lax.ppermute(
                    jnp.where(active, bottom_F, state["frontier_F"]),
                    "data", [(k, (k + 1) % D) for k in range(D)]),
                res_col=res_col,
                best=opt(state["best"], tile_best) if is_local else state["best"],
            )
            return new_state, None

        state, _ = jax.lax.scan(macro, state, jnp.arange(NB + D - 1))
        if is_local:
            return jax.lax.pmax(state["best"], "data")[None]
        # D[m][n] lives at local row (m-1) % mb on device (m-1) // mb
        owner = (m - 1) // mb
        val = jnp.where(d == owner,
                        jnp.sum(jnp.where(i_local == (m - 1) % mb,
                                          state["res_col"], 0)),
                        0)
        return jax.lax.psum(val, "data")[None]

    return shard_map(
        run, mesh=mesh,
        in_specs=(P("data"), P(None), P(None), P(None, None)),
        out_specs=P("data"), check_vma=False,
    )


#: shard_map in_specs of the function returned by ``_ring_plan`` — exported so
#: multi-process callers can build matching global arrays
#: (``__graft_entry__._multihost_worker``).
RING_IN_SPECS = (P("data"), P(None), P(None), P(None, None))


def _ring_plan(a, b, mesh: Mesh, match: int, mismatch: int, gap: int,
               objective: str, locality: str, table, extend, block_cols: int):
    """Shared front half of ``ring_wavefront_score``: pad/normalize operands
    and build the shard_map callable. Returns ``(early, fn, arrays)`` where
    ``early`` short-circuits empty operands; otherwise ``fn(*arrays)`` (with
    arrays placed according to ``RING_IN_SPECS``) yields the score. Split out
    so multi-host callers can place the arrays as global multi-process arrays
    before invoking ``fn``."""
    a = np.asarray(bytearray(a) if isinstance(a, (bytes, bytearray)) else a)
    b = np.asarray(bytearray(b) if isinstance(b, (bytes, bytearray)) else b)
    m, n = len(a), len(b)
    is_affine = extend is not None
    is_local = locality == "local"
    if m == 0 or n == 0:
        if is_local:
            return 0, None, None
        k = m + n
        if is_affine:
            return (gap + extend * (k - 1) if k else 0), None, None
        return k * gap, None, None
    D = mesh.devices.size
    mb = -(-m // D)
    C = min(block_cols, max(n, 1))
    NB = -(-n // C)
    a_pad = np.full(mb * D, -2, dtype=np.int32)
    a_pad[:m] = a
    b_pad = np.full(NB * C, -3, dtype=np.int32)
    b_pad[:n] = b
    mn = np.array([m, n], dtype=np.int32)
    tab = (np.zeros((32, 32), np.int32) if table is None
           else np.asarray(table, dtype=np.int32))
    fn = _build_ring(mesh, mb, C, NB, match, mismatch, gap,
                     extend if is_affine else 0, objective == "min",
                     is_affine, is_local, table is not None)
    return None, fn, (a_pad, b_pad, mn, tab)


def ring_wavefront_score(a, b, mesh: Mesh, match: int = 0, mismatch: int = 1,
                         gap: int = 1, objective: str = "min",
                         locality: str = "global",
                         table: np.ndarray | None = None,
                         extend: int | None = None,
                         block_cols: int = 256) -> int:
    """Score of ONE pair's DP sharded across ``mesh``'s ``data`` axis.

    Supports the full single-chip wavefront config space: uniform costs or a
    32×32 class-cost ``table`` (operands pre-mapped to class ids), linear
    gaps or Gotoh affine (``gap`` is OPEN and ``extend`` extends), global or
    ``locality="local"`` (Smith-Waterman) alignment, min/max objective."""
    early, fn, arrays = _ring_plan(a, b, mesh, match, mismatch, gap,
                                   objective, locality, table, extend,
                                   block_cols)
    if fn is None:
        return early
    out = fn(*(jnp.asarray(x) for x in arrays))
    return int(np.asarray(out)[0])
