"""Fingerprints engine — public API mirroring ``szs.Fingerprints``.

Reference Python type: ``stringzillas.Fingerprints(ndim, window_widths=None,
alphabet_size=256, seed=0, capabilities=None)`` (``python/stringzillas.c:
2085-2150``), called as ``engine(texts, device=None)`` and returning
``(min_hashes, min_counts)`` — two ``(docs, ndim) uint32`` arrays
(``python/stringzillas.c:2162-2300``, C ABI ``stringzillas.h:516-580``).

Outputs are bit-identical to the reference's f64 engines: the device form
computes the same 52-bit modular arithmetic in int32 limbs (see
``ops/fingerprints.py``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.fingerprints import (DEFAULT_WINDOW_WIDTHS, derive_params,
                                fingerprint_all_groups, pack_limbs)
from ..ops.tape import Tape, round_up
from .device_scope import DeviceScope, default_device_scope

__all__ = ["Fingerprints"]


def _dyadic(n: int, minimum: int = 8) -> int:
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


class Fingerprints:
    def __init__(self, ndim: int, window_widths=None, alphabet_size: int = 256,
                 seed: int = 0, capabilities=None):
        del capabilities  # accepted for API parity
        if ndim <= 0:
            raise ValueError("ndim must be positive")
        self.ndim = int(ndim)
        self.alphabet_size = int(alphabet_size)
        self.seed = int(seed)
        self.window_widths = tuple(int(w) for w in window_widths) if window_widths is not None else DEFAULT_WINDOW_WIDTHS
        self._params = derive_params(self.ndim, self.window_widths, self.seed)
        # Dimensions grouped by window width into contiguous row blocks (each
        # padded to a multiple of 8); ALL groups run in ONE pass with their
        # dims concatenated down the row axis.
        widths = self._params["width"]
        distinct = sorted(set(int(x) for x in widths))
        sizes, rows, pads = [], [], []
        row = 0
        for w in distinct:
            dim_idx = np.nonzero(widths == w)[0]
            g_pad = round_up(len(dim_idx), 8)
            pads.append(np.concatenate(
                [dim_idx, np.repeat(dim_idx[-1:], g_pad - len(dim_idx))]))
            sizes.append(g_pad)
            rows.append((row, dim_idx))
            row += g_pad
        pad = np.concatenate(pads)
        dims = row
        self._group_sizes = tuple(sizes)
        self._group_rows = rows  # (row_start, original dim indices) per group
        # Inverse permutation: output dim d lives at padded kernel row perm[d].
        perm = np.empty(self.ndim, dtype=np.int64)
        for row_start, dim_idx in rows:
            perm[dim_idx] = row_start + np.arange(len(dim_idx))
        self._perm = perm
        self._widths_arr = jnp.asarray(np.array([distinct], dtype=np.int32))
        self._mult = jnp.asarray(
            self._params["mult"][pad].astype(np.int32).reshape(dims, 1))
        self._m_limbs = jnp.asarray(
            pack_limbs(self._params["modulo"][pad]).reshape(2, dims, 1))
        self._fd_limbs = jnp.asarray(
            pack_limbs(self._params["fused_disc"][pad]).reshape(2, dims, 1))
        self._inv_m = jnp.asarray(
            (1.0 / self._params["modulo"][pad].astype(np.float32)).reshape(dims, 1))

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Fingerprints(ndim={self.ndim},window_widths={len(self.window_widths)},"
                f"alphabet_size={self.alphabet_size},seed={self.seed})")

    def __call__(self, texts, device: DeviceScope | None = None,
                 out=None, device_out: bool = False):
        """Min-hashes + count-mins for a collection.

        ``device_out=True`` returns the ``(n, ndim) uint32`` pair as
        device-resident jax arrays and skips the host pull entirely — the
        fast path for device-side consumers (LSH banding via
        ``ops.fingerprints.band_keys``, retrieval scoring) where the D2H of
        ndim*8 bytes/doc would otherwise dominate the pipeline."""
        scope = device or default_device_scope()
        ndev = scope.device_count
        from ..ops.pack_device import device_tape, pack_on_device

        tape = texts if isinstance(texts, Tape) else Tape.from_strings(
            [s.encode("utf-8") if isinstance(s, str) else bytes(s)
             for s in texts])
        dt = device_tape(tape)
        n = len(dt)
        min_hashes = np.full((n, self.ndim), 0xFFFFFFFF, dtype=np.uint32)
        min_counts = np.zeros((n, self.ndim), dtype=np.uint32)
        if n == 0:
            return min_hashes, min_counts

        lens = dt.lengths
        sizes = np.array([_dyadic(x) for x in lens], dtype=np.int64)
        # Enqueue every length bucket back-to-back, pull afterwards — the
        # device executes in order, so one sync covers all buckets instead
        # of a host round-trip per bucket. The blob rides to HBM once; the
        # ragged→dense pack is a device gather, not host work.
        pending = []
        for bucket in np.unique(sizes):
            idx = np.nonzero(sizes == bucket)[0]
            # Dyadic lane count: n_docs is a kernel compile key, so a dyadic
            # ladder bounds the number of compiled specializations across
            # calls/buckets (the padded lanes cost compute only — outputs
            # are sliced to the true count on device before the pull).
            count = round_up(1 << max(len(idx) - 1, 1).bit_length(),
                             128 * ndev)
            offs_j, lens_vec = dt.bucket_arrays(idx, count)
            docs_j = pack_on_device(dt.data, offs_j, lens_vec,
                                    row_len=int(bucket), transpose=True)
            lens_j = lens_vec.reshape(1, count)
            if ndev > 1:
                from ..parallel.cross import sharded_fingerprints

                h, c = sharded_fingerprints(
                    docs_j, lens_j, self._widths_arr, self._group_sizes,
                    self._mult, self._m_limbs, self._fd_limbs, self._inv_m,
                    scope.mesh,
                )
            else:
                h, c = fingerprint_all_groups(
                    docs_j, lens_j, self._widths_arr, self._group_sizes,
                    self._mult, self._m_limbs, self._fd_limbs, self._inv_m,
                )
            pending.append((idx, h[:, : len(idx)], c[:, : len(idx)]))
        if device_out:
            import jax.numpy as jnp

            perm = jnp.asarray(self._perm)
            dh = jnp.full((n, self.ndim), -1, jnp.int32)
            dc = jnp.zeros((n, self.ndim), jnp.int32)
            for idx, h, c in pending:
                rows = jnp.asarray(idx)
                dh = dh.at[rows].set(h[perm].T)
                dc = dc.at[rows].set(c[perm].T)
            return dh.view(jnp.uint32), dc.view(jnp.uint32)
        for idx, h, c in pending:
            h = np.asarray(h).view(np.uint32)
            c = np.asarray(c).view(np.uint32)
            # One permutation take + transpose (contiguous row gather) instead
            # of per-group two-axis fancy indexing — the export was the
            # single biggest host cost at 8K+ docs.
            min_hashes[idx] = h[self._perm, : len(idx)].T
            min_counts[idx] = c[self._perm, : len(idx)].T

        if out is not None:
            out_h, out_c = out
            out_h[...] = min_hashes
            out_c[...] = min_counts
            return out_h, out_c
        return min_hashes, min_counts
