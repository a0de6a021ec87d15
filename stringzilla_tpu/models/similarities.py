"""Batch similarity engines — the public API mirroring ``szs.*``.

Engine classes correspond one-to-one to the reference's Python binding types
(``python/stringzillas.c:96-101``): ``LevenshteinDistances``,
``LevenshteinDistancesUTF8``, ``NeedlemanWunsch``, ``SmithWaterman``. Call
convention matches ``LevenshteinDistances_vectorcall`` (reference
``python/stringzillas.c:581-700``):

    engine(queries, candidates=None, device=None, out=None) -> np.ndarray

``candidates=None`` computes symmetric self-similarity. Distances return
``uint64`` (C ABI ``sz_size_t*``, reference ``stringzillas.h:199``), scores
return ``int64`` (``sz_ssize_t*``, ``stringzillas.h:358``).

Host-side scheduling: inputs are grouped into dyadic length buckets (the
reference's ``candidate_length_bucket_`` trick, ``serial.hpp:3442-3444``) so
every device program sees a static shape with <2x padding waste; each
(query-bucket x candidate-bucket) tile is scored on the device — the Myers
kernel for unit costs, the lane-packed DP for the rest — and scattered into
the result matrix.
"""

from __future__ import annotations



import numpy as np
import jax.numpy as jnp

from ..ops.similarity import (
    AffineGaps,
    ClassCosts,
    LinearGaps,
    SimilarityConfig,
    UniformCosts,
)
from ..ops.myers import LANE_BLOCK, myers_distances
from ..utils import native
from ..ops.similarity import score_batch
from ..ops.tape import Tape, round_up
from ..parallel.cross import sharded_myers, sharded_similarity
from .device_scope import DeviceScope, default_device_scope

__all__ = [
    "LevenshteinDistances",
    "LevenshteinDistancesUTF8",
    "NeedlemanWunschScores",
    "SmithWatermanScores",
    "NeedlemanWunsch",
    "SmithWaterman",
]

_QUERY_PAD = 8  # query-count granularity bounding jit specializations
_LONG_THRESHOLD = 4096  # beyond this, pairs route to the wavefront tier


def _decode_utf8_runes(data: bytes) -> np.ndarray:
    """Decode to 32-bit runes; invalid bytes become U+FFFD (the reference's
    maximal-subpart resync, ``README.md:888-893``)."""
    return np.array([ord(c) for c in data.decode("utf-8", errors="replace")], dtype=np.int32)


def _reject_integer_like(s) -> None:
    """Integer-like items must raise TypeError like the reference binding —
    ``bytes(n)`` would silently yield an n-byte ZERO-FILLED string."""
    import operator

    try:
        operator.index(s)
    except TypeError:
        return
    raise TypeError(f"expected a string-like item, got {type(s).__name__}")


def _as_int_arrays(items, utf8: bool) -> list[np.ndarray]:
    if isinstance(items, Tape):
        items = items.to_list()
    out = []
    for s in items:
        if isinstance(s, str):
            s = s.encode("utf-8")
        elif not isinstance(s, (bytes, np.ndarray)):
            _reject_integer_like(s)
            s = bytes(s)  # bytearray/memoryview/Str views
        if isinstance(s, np.ndarray):
            out.append(s.astype(np.int32))
        elif utf8:
            out.append(_decode_utf8_runes(s))
        else:
            out.append(np.frombuffer(s, dtype=np.uint8).astype(np.int32))
    return out


def _dyadic(n: int, minimum: int = 8) -> int:
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def _group_dyadic(lengths: np.ndarray) -> dict[int, np.ndarray]:
    sizes = np.array([_dyadic(n) for n in lengths], dtype=np.int64)
    return {int(b): np.nonzero(sizes == b)[0] for b in np.unique(sizes)}


def _as_tape(arrs) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate int32 char arrays into a contiguous tape + offsets — the
    layout the native packer (``tc_pack_runes_i32``) consumes."""
    lens = np.fromiter((len(a) for a in arrs), dtype=np.int64, count=len(arrs))
    offsets = np.zeros(len(arrs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = (np.concatenate(arrs) if len(arrs) and offsets[-1]
            else np.zeros(0, dtype=np.int32)).astype(np.int32)
    return data, offsets


class _HostFallback(Exception):
    """Raised when a collection can't take the device-resident path
    (pre-decoded ndarray inputs, or malformed UTF-8 needing the host's
    maximal-subpart U+FFFD semantics)."""


class _HostCollection:
    """Legacy host-packed collection: int arrays + native ragged→dense pack
    (kept as the exact-semantics fallback and the ndarray-input path)."""

    def __init__(self, items, utf8: bool, b2c):
        arrs = _as_int_arrays(items, utf8)
        if b2c is not None:
            arrs = [b2c[a].astype(np.int32) for a in arrs]
        self._arrs = arrs
        self.lens = np.array([len(a) for a in arrs], dtype=np.int64)
        self._tape, self._offsets = _as_tape(arrs)

    def __len__(self) -> int:
        return len(self._arrs)

    def array(self, i: int) -> np.ndarray:
        return self._arrs[i]

    def pack_candidates(self, idx, length, count_multiple):
        count = round_up(1 << max(len(idx) - 1, 1).bit_length(),
                         count_multiple)
        block, lens = native.pack_i32(self._tape, self._offsets,
                                      np.asarray(idx), count, length,
                                      transpose=True, fill=0, runes=True)
        return jnp.asarray(block), jnp.asarray(lens.reshape(1, count))

    def pack_queries_myers(self, idx, rows):
        """Myers layout: plain query chars (no +1 shift), padded with -1
        (never equal to any real char/rune). ``rows`` is a multiple of 32."""
        count = round_up(max(len(idx), 1), _QUERY_PAD)
        q_t, lens = native.pack_i32(self._tape, self._offsets,
                                    np.asarray(idx), count, rows,
                                    transpose=True, fill=-1, runes=True)
        return jnp.asarray(q_t), jnp.asarray(lens.reshape(count, 1))

    def pack_queries(self, idx, rows):
        count = round_up(max(len(idx), 1), _QUERY_PAD)
        # +1-shifted layout: row 0 unused; pack into rows-1 then prepend.
        body, lens = native.pack_i32(self._tape, self._offsets,
                                     np.asarray(idx), count, rows - 1,
                                     transpose=True, fill=0, runes=True)
        q_ext_t = np.concatenate([np.zeros((1, count), np.int32), body],
                                 axis=0)
        return jnp.asarray(q_ext_t), jnp.asarray(lens.reshape(count, 1))


def _class_mapped_tape(dt, b2c):
    """Device tape whose blob bytes are pre-mapped through the 256-entry
    byte→class LUT (one gather pass over the whole blob). Memoized on the
    device tape keyed by the LUT bytes, so repeated engine calls over the
    same collection pay it once (tapes are immutable)."""
    from ..ops.memory import lookup_transform
    from ..ops.pack_device import DeviceTape

    key = bytes(np.asarray(b2c, dtype=np.uint8))
    cache = getattr(dt, "_class_mapped", None)
    if cache is None:
        cache = dt._class_mapped = {}
    hit = cache.get(key)
    if hit is not None:
        return hit
    mapped = lookup_transform(dt.data, np.asarray(b2c))
    out = DeviceTape(data=mapped, starts=dt.starts, lengths=dt.lengths)
    cache[key] = out
    return out


class _DeviceCollection:
    """Device-resident collection: the byte blob rides to HBM once; every
    dense DP block is gathered (and for ``_utf8`` engines decoded to runes,
    ``ops/utf8_pack_device.py``) on device — no host packing or decoding on
    the hot path."""

    def __init__(self, items, utf8: bool, b2c):
        from ..ops.pack_device import device_tape

        if isinstance(items, Tape):
            tape = items
        else:
            conv = []
            for s in items:
                if isinstance(s, str):
                    s = s.encode("utf-8")
                elif isinstance(s, np.ndarray):
                    if s.dtype == np.uint8 and s.ndim == 1:
                        s = s.tobytes()  # values == raw bytes, device-safe
                    else:
                        # Pre-decoded int arrays keep the host path (their
                        # VALUES are chars/runes; memoryview would
                        # reinterpret raw bytes).
                        raise _HostFallback
                elif not isinstance(s, bytes):
                    _reject_integer_like(s)
                    s = bytes(s)  # bytearray/memoryview/Str views
                conv.append(s)
            tape = Tape.from_strings(conv)
        self._tape = tape
        self._dt = device_tape(tape)
        self._utf8 = utf8
        self._b2c = b2c
        self._lut = (jnp.asarray(np.asarray(b2c).astype(np.int32))
                     if b2c is not None else jnp.zeros(256, jnp.int32))
        # Class-cost engines: byte→class map applied to the BLOB once —
        # every later per-call pack gathers pre-mapped bytes instead of
        # paying a 256-entry gather per element per call.
        self._dt_packsrc = self._dt
        if b2c is not None and not utf8:
            self._dt_packsrc = _class_mapped_tape(self._dt, b2c)
        self._byte_lens = tape.lengths
        if utf8:
            from ..ops.utf8_pack_device import rune_count_validity

            n = len(tape)
            counts = np.zeros(n, dtype=np.int64)
            for bl, bidx in _group_dyadic(self._byte_lens).items():
                cnt, viol = rune_count_validity(self._dt, bidx, bl)
                if viol.any():
                    raise _HostFallback
                counts[bidx] = cnt
            self.lens = counts
        else:
            self.lens = self._byte_lens

    def __len__(self) -> int:
        return len(self._tape)

    def array(self, i: int) -> np.ndarray:
        """Host materialization for the per-pair wavefront tier."""
        b = self._tape[i]
        if self._utf8:
            return np.array([ord(c) for c in b.decode("utf-8")],
                            dtype=np.int32)
        a = np.frombuffer(b, dtype=np.uint8).astype(np.int32)
        if self._b2c is not None:
            a = self._b2c[a].astype(np.int32)
        return a

    def _byte_bucket(self, idx) -> int:
        return _dyadic(int(self._byte_lens[idx].max()) if len(idx) else 1)

    def _pack(self, idx, lanes, rows, fill, shift):
        from ..ops.pack_device import pack_chars
        from ..ops.utf8_pack_device import decode_pack_device

        if self._utf8:
            return decode_pack_device(self._dt, idx, lanes,
                                      self._byte_bucket(idx),
                                      rows, fill=fill, transpose=True,
                                      shift=shift)
        offs, lens = self._dt.bucket_arrays(np.asarray(idx, np.int64), lanes)
        return pack_chars(self._dt_packsrc.data, offs, lens, self._lut,
                          row_len=rows, transpose=True, fill=fill,
                          shift=shift, use_lut=False)

    def _lens_vec(self, idx, count, shape):
        lens = np.zeros(count, dtype=np.int32)
        lens[: len(idx)] = self.lens[idx]
        return jnp.asarray(lens.reshape(shape))

    def pack_candidates(self, idx, length, count_multiple):
        count = round_up(1 << max(len(idx) - 1, 1).bit_length(),
                         count_multiple)
        return (self._pack(idx, count, length, fill=0, shift=False),
                self._lens_vec(idx, count, (1, count)))

    def pack_queries_myers(self, idx, rows):
        count = round_up(max(len(idx), 1), _QUERY_PAD)
        return (self._pack(idx, count, rows, fill=-1, shift=False),
                self._lens_vec(idx, count, (count, 1)))

    def pack_queries(self, idx, rows):
        count = round_up(max(len(idx), 1), _QUERY_PAD)
        return (self._pack(idx, count, rows - 1, fill=0, shift=True),
                self._lens_vec(idx, count, (count, 1)))


class _CrossProductEngine:
    """Shared host driver for all-pairs DP scoring."""

    result_dtype = np.int64
    _utf8 = False

    def __init__(self, cfg: SimilarityConfig):
        self._cfg = cfg
        self._table = (
            jnp.asarray(cfg.costs.table_np()) if cfg.uses_classes else None
        )
        self._b2c = cfg.costs.byte_to_class_np() if cfg.uses_classes else None

    @property
    def _is_unit_cost(self) -> bool:
        """Unit-cost Levenshtein routes to the Myers bit-parallel kernel —
        the same dispatch rule as the reference (``serial.hpp:2620-2720``)."""
        return (
            self._cfg.objective == "min"
            and self._cfg.locality == "global"
            and isinstance(self._cfg.gaps, LinearGaps)
            and self._cfg.gaps.open_or_extend == 1
            and isinstance(self._cfg.costs, UniformCosts)
            and self._cfg.costs.match == 0
            and self._cfg.costs.mismatch == 1
        )

    def _collection(self, items):
        try:
            return _DeviceCollection(items, self._utf8, self._b2c)
        except _HostFallback:
            return _HostCollection(items, self._utf8, self._b2c)

    def _score_long_pairs(self, qc, cc, q_long, c_long, out, scope):
        """Every pair touching a long string runs on the anti-diagonal
        wavefront (one device program per pair — the intra-pair tier).
        Pairs whose diagonal exceeds ``RING_MIN_CELLS`` route to the
        cross-device ring tier when the scope holds a multi-device mesh —
        the reference's GPU ``row_frontier`` pattern
        (``cuda.cuh:708-749``).
        Class-cost engines pass the 32x32 table (inputs are already
        class-mapped); uniform engines pass match/mismatch.

        Unit-cost configs route to the Ukkonen band-doubling tier
        (``levenshtein_long_pair``) instead of the flat wavefront: band
        doubling is exact by Ukkonen's lemma and strictly cheaper whenever
        the true distance is below ~half the shorter length — the dominant
        near-duplicate long-pair workload (the reference's analog is its
        bounded Levenshtein mode + the CUDA live-tile walk,
        ``cuda.cuh:708-749``)."""
        from ..ops import wavefront
        from ..parallel.ring import ring_wavefront_score

        cfg = self._cfg
        if cfg.is_affine:
            gap = cfg.gaps.open
            kw = dict(extend=cfg.gaps.extend)
        else:
            gap = cfg.gaps.open_or_extend
            kw = {}
        if cfg.uses_classes:
            kw["table"] = cfg.costs.table_np()
        else:
            kw.update(match=cfg.costs.match, mismatch=cfg.costs.mismatch)
        q_cache: dict = {}
        c_cache: dict = {}
        for i in range(len(qc)):
            for j in range(len(cc)):
                if not (q_long[i] or c_long[j]):
                    continue
                q = q_cache.get(i)
                if q is None:
                    q = q_cache[i] = qc.array(i)
                c = c_cache.get(j)
                if c is None:
                    c = (q_cache[j] if cc is qc and j in q_cache
                         else cc.array(j))
                    c_cache[j] = c
                if (max(len(q) + 1, len(c)) > wavefront.RING_MIN_CELLS
                        and scope.device_count > 1):
                    rkw = dict(kw)
                    rkw.setdefault("match", 0)
                    rkw.setdefault("mismatch", 1)
                    out[i, j] = ring_wavefront_score(
                        q, c, scope.mesh, gap=gap, objective=cfg.objective,
                        locality=cfg.locality, **rkw)
                elif self._is_unit_cost:
                    out[i, j] = wavefront.levenshtein_long_pair(q, c)
                else:
                    out[i, j] = wavefront.wavefront_score(
                        q, c, gap=gap, objective=cfg.objective,
                        locality=cfg.locality, **kw)

    @property
    def config(self) -> SimilarityConfig:
        return self._cfg

    def __call__(self, queries, candidates=None, device: DeviceScope | None = None,
                 out: np.ndarray | None = None) -> np.ndarray:
        scope = device or default_device_scope()
        qc = self._collection(queries)
        cc = qc if candidates is None else self._collection(candidates)

        nq, nc = len(qc), len(cc)
        if out is None:
            out = np.zeros((nq, nc), dtype=self.result_dtype)
        elif out.shape != (nq, nc):
            raise ValueError(f"out must have shape {(nq, nc)}, got {out.shape}")
        if nq == 0 or nc == 0:
            return out

        q_lens = qc.lens
        c_lens = cc.lens
        ndev = scope.device_count
        use_myers = self._is_unit_cost and int(q_lens.max()) > 0

        # Long-pair tier: strings beyond the lane-packed tiers' reach route
        # pair-by-pair to the anti-diagonal wavefront — the analog of
        # the reference's intra-pair large tier (``cross_in_parallel_``,
        # serial.hpp:3334-3345).
        q_long = q_lens > _LONG_THRESHOLD
        c_long = c_lens > _LONG_THRESHOLD
        has_long = bool(q_long.any() or c_long.any())
        if has_long:
            self._score_long_pairs(qc, cc, q_long, c_long, out, scope)
            if (~q_long).sum() == 0 or (~c_long).sum() == 0:
                return out

        for c_bucket, c_idx in _group_dyadic(c_lens).items():
            if has_long:
                c_idx = c_idx[~c_long[c_idx]]
                if c_idx.size == 0:
                    continue
            count_multiple = LANE_BLOCK * ndev
            block_j, lens_j = cc.pack_candidates(c_idx, c_bucket, count_multiple)
            for q_bucket, q_idx in _group_dyadic(q_lens).items():
                if has_long:
                    q_idx = q_idx[~q_long[q_idx]]
                    if q_idx.size == 0:
                        continue
                if use_myers:
                    rows = round_up(q_bucket, 32)
                    q_t, qlens = qc.pack_queries_myers(q_idx, rows)
                    if ndev > 1:
                        res = sharded_myers(
                            q_t, qlens, block_j, lens_j, scope.mesh,
                            alphabet=None if self._utf8 else 256)
                    else:
                        res = myers_distances(
                            q_t, qlens, block_j, lens_j,
                            alphabet=None if self._utf8 else 256)
                else:
                    rows = round_up(q_bucket + 1, 8)
                    q_ext_t, qlens = qc.pack_queries(q_idx, rows)
                    if ndev > 1:
                        res = sharded_similarity(
                            q_ext_t, qlens, block_j, lens_j,
                            self._cfg, scope.mesh, table=self._table)
                    else:
                        res = score_batch(q_ext_t, qlens, block_j, lens_j,
                                          self._cfg, table=self._table)
                # slice to true counts ON DEVICE — the dyadic lane padding
                # must not inflate the host pull
                res = np.asarray(res[: len(q_idx), : len(c_idx)])
                out[np.ix_(q_idx, c_idx)] = res.astype(self.result_dtype)
        return out


def _gaps_from(open: int, extend: int):
    # The reference linearizes affine gaps when open == extend
    # (``levenshtein_distance`` dispatch, serial.hpp:2620-2720).
    return LinearGaps(open) if open == extend else AffineGaps(open, extend)


class LevenshteinDistances(_CrossProductEngine):
    """Batched byte-level edit distances (reference engine
    ``szs::levenshtein_distances``, ``serial.hpp:3709-3760``; Python type
    ``python/stringzillas.c:388-470``)."""

    result_dtype = np.uint64

    def __init__(self, match: int = 0, mismatch: int = 1, open: int = 1,
                 extend: int = 1, capabilities=None):
        for name, v in (("match", match), ("mismatch", mismatch), ("open", open), ("extend", extend)):
            if not (-128 <= v <= 127):
                raise ValueError(f"{name} cost must fit in 8-bit signed integer")
        del capabilities  # accepted for API parity; dispatch is automatic
        super().__init__(
            SimilarityConfig("min", "global", _gaps_from(open, extend),
                             UniformCosts(match, mismatch))
        )


class LevenshteinDistancesUTF8(LevenshteinDistances):
    """Edit distances over Unicode codepoints rather than bytes (reference
    ``levenshtein_distance_utf8``, ``serial.hpp:2800``)."""

    _utf8 = True


class _ScoreEngine(_CrossProductEngine):
    result_dtype = np.int64
    _locality = "global"

    def __init__(self, byte_to_class=None, class_substitution_costs=None,
                 open: int = -1, extend: int = -1, capabilities=None,
                 substitution_matrix=None):
        """Signature and defaults mirror the reference binding
        (``python/stringzillas.c:1236-1250``): positional
        ``(byte_to_class, class_substitution_costs, open=-1, extend=-1)``.
        ``substitution_matrix`` additionally accepts a dense 256x256 (or 32x32)
        matrix and compresses it to the class form."""
        del capabilities  # accepted for API parity; dispatch is automatic
        if substitution_matrix is not None:
            m = np.asarray(substitution_matrix)
            if m.shape == (256, 256):
                byte_to_class, class_substitution_costs = _compress_256(m)
            elif m.shape == (32, 32):
                byte_to_class = np.arange(256, dtype=np.uint8) % 32
                class_substitution_costs = m
            else:
                raise ValueError("substitution_matrix must be 256x256 or 32x32")
        if byte_to_class is None or class_substitution_costs is None:
            raise ValueError("provide byte_to_class + class_substitution_costs or substitution_matrix")
        costs = ClassCosts.from_arrays(byte_to_class, class_substitution_costs)
        super().__init__(
            SimilarityConfig("max", self._locality, _gaps_from(open, extend), costs)
        )


def _compress_256(matrix: np.ndarray):
    """Compress a 256x256 cost matrix into class-map + 32x32 table when it has
    <= 32 distinct rows (the reference requires callers to supply the compact
    form; we accept the dense one for convenience)."""
    rows, inverse = np.unique(matrix, axis=0, return_inverse=True)
    if len(rows) > 32:
        raise ValueError("substitution matrix has more than 32 distinct byte classes")
    byte_to_class = inverse.astype(np.uint8)
    table = np.zeros((32, 32), dtype=np.int32)
    reps = [np.nonzero(inverse == k)[0][0] for k in range(len(rows))]
    for a, ra in enumerate(reps):
        for b, rb in enumerate(reps):
            table[a, b] = matrix[ra, rb]
    return byte_to_class, table


class NeedlemanWunschScores(_ScoreEngine):
    """Global alignment scores (reference ``needleman_wunsch_scores``,
    ``serial.hpp:3771+``; Python type ``stringzillas.NeedlemanWunschScores``,
    ``python/stringzillas.c:1612``)."""

    _locality = "global"


class SmithWatermanScores(_ScoreEngine):
    """Local alignment scores (reference ``smith_waterman_scores``,
    ``serial.hpp:3123``; Python type ``stringzillas.SmithWatermanScores``,
    ``python/stringzillas.c:2037``)."""

    _locality = "local"


# Convenience aliases
NeedlemanWunsch = NeedlemanWunschScores
SmithWaterman = SmithWatermanScores
