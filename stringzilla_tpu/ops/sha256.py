"""FIPS 180-4 SHA-256 — own implementation, host streaming + device batch.

The reference implements SHA-256 per ISA tier with a streaming state struct
(``sz_sha256_state_t``: init/update/digest, reference
``include/stringzilla/hash.h:244-300``) plus SHA-NI/NEON-crypto kernels. On
the device there is no crypto unit; the hot shape is the *batch*: thousands of
documents hashed in parallel, rounds vectorized across a lanes axis (the same layout as the token
hashes). Within one message SHA-256
is strictly sequential by construction, so the single-stream tier is an
exact numpy implementation of the compression function; throughput comes
from ``sha256_batch`` which runs one round for *all* messages per step.

The round constants are derived here from integer cube/square roots of the
first primes (exactly as FIPS 180-4 §4.2.2 defines them) rather than pasted
as literals — bit-for-bit identical, checked against hashlib in the tests.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["Sha256", "sha256", "sha256_batch", "hmac_sha256"]


def _first_primes(n: int) -> list[int]:
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out if p * p <= c):
            out.append(c)
        c += 1
    return out


def _iroot(x: int, k: int) -> int:
    """Floor k-th root of a big integer (exact, no float rounding)."""
    r = int(round(x ** (1.0 / k)))
    while r ** k > x:
        r -= 1
    while (r + 1) ** k <= x:
        r += 1
    return r


_PRIMES = _first_primes(64)
# H0: first 32 bits of the fractional parts of sqrt(p), p in first 8 primes
_H0 = np.array([_iroot(p << 64, 2) & 0xFFFFFFFF for p in _PRIMES[:8]],
               dtype=np.uint32)
# K: first 32 bits of the fractional parts of cbrt(p), p in first 64 primes
_K = np.array([_iroot(p << 96, 3) & 0xFFFFFFFF for p in _PRIMES],
              dtype=np.uint32)


def _rotr(x, n):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _compress_np(state: np.ndarray, block: bytes | np.ndarray) -> np.ndarray:
    """One 64-byte block through the compression function (numpy u32)."""
    with np.errstate(over="ignore"):
        w = np.frombuffer(bytes(block), dtype=">u4").astype(np.uint32)
        W = np.empty(64, dtype=np.uint32)
        W[:16] = w
        for t in range(16, 64):
            s0 = _rotr(W[t - 15], 7) ^ _rotr(W[t - 15], 18) ^ (W[t - 15] >> np.uint32(3))
            s1 = _rotr(W[t - 2], 17) ^ _rotr(W[t - 2], 19) ^ (W[t - 2] >> np.uint32(10))
            W[t] = W[t - 16] + s0 + W[t - 7] + s1
        a, b, c, d, e, f, g, h = state
        kw = _K + W
        for t in range(64):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + S1 + ch + kw[t]
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = S0 + maj
            h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
        return state + np.array([a, b, c, d, e, f, g, h], dtype=np.uint32)


def _compress_many(state: np.ndarray, buf: bytes) -> np.ndarray:
    """All full 64-byte blocks of ``buf`` through the compressor — native
    (SHA-NI / scalar C++) when the host library is available, numpy rounds
    otherwise. Returns the NEW state; never mutates the argument."""
    from ..utils import native

    st = state.copy()
    if native.sha256_compress(st, np.frombuffer(buf, dtype=np.uint8)):
        return st
    for i in range(len(buf) // 64):
        state = _compress_np(state, buf[i * 64 : (i + 1) * 64])
    return state


class Sha256:
    """Streaming SHA-256 (``sz_sha256_state_init/update/digest``, reference
    ``hash.h:283-300``) — own FIPS 180-4 implementation, no hashlib."""

    def __init__(self, data: bytes = b""):
        self._state = _H0.copy()
        self._buffer = b""
        self._length = 0  # total bytes absorbed
        if data:
            self.update(data)

    def update(self, data: bytes) -> "Sha256":
        data = bytes(data)
        self._length += len(data)
        buf = self._buffer + data
        n_full = len(buf) // 64
        if n_full:
            self._state = _compress_many(self._state, buf[: n_full * 64])
        self._buffer = buf[n_full * 64 :]
        return self

    def copy(self) -> "Sha256":
        out = Sha256()
        out._state = self._state.copy()
        out._buffer = self._buffer
        out._length = self._length
        return out

    def digest(self) -> bytes:
        state, buf = self._state, self._buffer
        pad = b"\x80" + b"\x00" * ((55 - self._length) % 64)
        tail = buf + pad + (self._length * 8).to_bytes(8, "big")
        return _compress_many(state, tail).astype(">u4").tobytes()

    def hexdigest(self) -> str:
        return self.digest().hex()

    def reset(self) -> "Sha256":
        """Return to the empty-message state (``Sha256.reset``, reference
        ``python/stringzilla.c:7513``)."""
        self._state = _H0.copy()
        self._buffer = b""
        self._length = 0
        return self


def sha256(data: bytes) -> bytes:
    from ..utils import native

    d = native.sha256_one(np.frombuffer(bytes(data), dtype=np.uint8))
    return d if d is not None else Sha256(data).digest()


# ---------------------------------------------------------------------------
# Batched device path — rounds vectorized across the message axis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _jit_batch():
    """Compression over the lanes (message) axis: the 48 schedule-expansion
    and 64 round steps and the block axis are each a ``lax.scan``. (A fully
    unrolled form compiles for minutes and runs slower on the GPU.)"""
    import jax
    import jax.numpy as jnp

    def rotr(x, k):
        return (x >> np.uint32(k)) | (x << np.uint32(32 - k))

    k_col = jnp.asarray(_K)[:, None]  # (64, 1)

    def block_step_scan(st, blk):  # blk (16, G)
        def expand_step(ring, _):
            w16, w15, w7, w2 = ring[0], ring[1], ring[9], ring[14]
            s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> np.uint32(3))
            s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> np.uint32(10))
            wt = w16 + s0 + w7 + s1
            return jnp.concatenate([ring[1:], wt[None]], axis=0), wt

        def round_step(st, kw):
            a, b, c, d, e, f, g, h = st
            S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + S1 + ch + kw
            S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            return (t1 + S0 + maj, a, b, c, d + t1, e, f, g), None

        _, w_ext = jax.lax.scan(expand_step, blk, None, length=48)
        W = jnp.concatenate([blk, w_ext], axis=0)  # (64, G)
        out, _ = jax.lax.scan(round_step, st, k_col + W)
        return tuple(x + y for x, y in zip(st, out)), None

    def run(words):  # (n_blocks, 16, G) uint32
        G = words.shape[2]
        state0 = tuple(jnp.broadcast_to(jnp.uint32(int(h)), (G,))
                       for h in _H0)
        state, _ = jax.lax.scan(block_step_scan, state0, words)
        return jnp.stack(state, 0)  # (8, G)

    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _jit_tape_batch(n_blocks: int):
    """End-to-end device program for one block-count bucket: gather message
    bytes from the resident blob, apply the FIPS 180-4 padding (0x80 marker
    + big-endian bit length) and big-endian word packing *on device*, then
    run the batched compression. The only host work left is bucketing."""
    import jax
    import jax.numpy as jnp

    inner = _jit_batch()
    L = n_blocks * 64

    def run(blob, offs, lens):  # offs/lens int32[lanes]
        lanes = offs.shape[0]
        j = jnp.arange(L, dtype=jnp.int32)
        pos = offs[:, None] + j[None, :]
        valid = j[None, :] < lens[:, None]
        safe = jnp.where(valid, pos, 0)
        b = jnp.take(blob, safe.reshape(-1), axis=0).reshape(lanes, L)
        b = jnp.where(valid, b.astype(jnp.uint32), jnp.uint32(0))
        b = jnp.where(j[None, :] == lens[:, None], jnp.uint32(0x80), b)
        # big-endian 64-bit bit length in the last 8 bytes (hi/lo u32 halves
        # — the lanes stay 32-bit; messages are < 2^28 bytes by construction)
        bits_lo = (lens.astype(jnp.uint32)) << jnp.uint32(3)
        bits_hi = (lens.astype(jnp.uint32)) >> jnp.uint32(29)
        k = j - (L - 8)
        sh_hi = (jnp.uint32(8) * (3 - k).astype(jnp.uint32))
        sh_lo = (jnp.uint32(8) * (7 - k).astype(jnp.uint32))
        tail = jnp.where(k[None, :] < 4,
                         (bits_hi[:, None] >> sh_hi[None, :]) & jnp.uint32(0xFF),
                         (bits_lo[:, None] >> sh_lo[None, :]) & jnp.uint32(0xFF))
        b = jnp.where(k[None, :] >= 0, tail, b)
        # pack 4 bytes big-endian → u32 words, (lanes, L/4) → (nb, 16, lanes)
        bb = b.reshape(lanes, L // 4, 4)
        w = ((bb[:, :, 0] << jnp.uint32(24)) | (bb[:, :, 1] << jnp.uint32(16))
             | (bb[:, :, 2] << jnp.uint32(8)) | bb[:, :, 3])
        words = w.reshape(lanes, n_blocks, 16).transpose(1, 2, 0)
        return inner(words)  # (8, lanes) uint32

    return jax.jit(run)


# Device batch path handles messages below this (the 64-bit FIPS bit length
# is carried as two u32 halves; 2^28 B = 256 MB keeps every shift exact).
_TAPE_MAX_LEN = 1 << 28


def sha256_tape(tape, indices: np.ndarray | None = None) -> np.ndarray:
    """SHA-256 over a :class:`~stringzilla_tpu.ops.tape.Tape` (or
    ``DeviceTape``), shape ``(n, 32) uint8`` — the honest end-to-end path:
    raw bytes up once, padding/packing/rounds on device, 32 B per digest
    back. Reference contract: ``sz_sha256_state_*`` (``hash.h:283-300``)
    applied per collection element."""
    from .pack_device import device_tape

    dt = device_tape(tape)
    if indices is None:
        indices = np.arange(len(dt))
    indices = np.asarray(indices, dtype=np.int64)
    out = np.empty((len(indices), 32), dtype=np.uint8)
    if len(indices) == 0:
        return out
    all_lens = dt.lengths[indices]
    if int(all_lens.max()) >= _TAPE_MAX_LEN:
        raise ValueError("sha256_tape: messages must be < 256 MB")
    blocks = (all_lens + 8) // 64 + 1
    pending = []
    for n_blocks in np.unique(blocks):
        rows = np.nonzero(blocks == n_blocks)[0]
        G = len(rows)
        lanes = max(128, 1 << (G - 1).bit_length())
        offs, lens = dt.bucket_arrays(indices[rows], lanes)
        fn = _jit_tape_batch(int(n_blocks))
        pending.append((rows, G, fn(dt.data, offs, lens)))
    for rows, G, digests in pending:
        d = np.asarray(digests)[:, :G]  # (8, G) uint32
        out[rows] = (np.ascontiguousarray(d.T).astype(">u4")
                     .view(np.uint8).reshape(G, 32))
    return out


def sha256_batch(items) -> np.ndarray:
    """SHA-256 digests of a collection, shape ``(n, 32) uint8``. Messages
    are grouped by padded block count; each group's gather + FIPS padding +
    rounds run as one device program across the lane axis (the counterpart
    of the reference's thread-pool batch hashing in ``szs``).

    Dispatch: host-resident bytes go through the native (SHA-NI) host tier
    when the library is built — hashing is compute-light enough that the
    link crossing only pays off for data already living in HBM; a
    device-array tape (or no native toolchain) takes the device kernel via
    :func:`sha256_tape`."""
    from ..utils import native
    from .tape import Tape

    tape = items if isinstance(items, Tape) else Tape.from_strings(
        [bytes(s) for s in items])
    if isinstance(tape.data, np.ndarray):
        out = native.sha256_tape(tape.data, tape.offsets)
        if out is not None:
            return out
    return sha256_tape(tape)


def hmac_sha256(key: bytes, message: bytes) -> bytes:
    """RFC 2104 HMAC over the own SHA-256 (reference exposes ``hmac_sha256``
    in its Python binding)."""
    key = bytes(key)
    if len(key) > 64:
        key = sha256(key)
    key = key.ljust(64, b"\x00")
    ipad = bytes(b ^ 0x36 for b in key)
    opad = bytes(b ^ 0x5C for b in key)
    return sha256(opad + sha256(ipad + bytes(message)))
