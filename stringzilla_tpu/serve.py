"""Out-of-process engine serving — the counterpart of the reference's
engine-level C ABI (``include/stringzillas/stringzillas.h:104-597``).

The reference exports ``szs_*`` C entry points so non-C callers can reach its
batch engines in-process.  A JAX/XLA runtime cannot usefully sit behind a C
ABI (it owns a Python interpreter, a compiler, and device state), so this
framework's equivalent is a *process boundary*: one worker process holds the
jitted engines warm and serves them over a Unix-domain socket with a
length-prefixed binary protocol simple enough to speak from any language
(the wire format is: 4-byte LE header length, a JSON header, then raw
little-endian array bytes — no Python anywhere in the contract).

Protocol
--------
Request header::

    {"op": "levenshtein" | "levenshtein_utf8" | "needleman_wunsch" |
           "smith_waterman" | "fingerprints" | "hash" | "sha256",
     "queries": <count>, "candidates": <count>,   # tape entry counts
     ...op-specific params...,
     "payload": [[name, dtype, [shape...]], ...]} # order of the raw blocks

Payload blocks follow immediately, each ``prod(shape) * itemsize`` bytes.
String collections travel as Arrow-style tapes: ``<name>_offsets``
(int64, count+1) + ``<name>_data`` (uint8).  The response mirrors the
shape: a JSON header (``{"ok": true, "payload": [...]}`` or
``{"ok": false, "error": ...}``) followed by the result blocks.

The server is intentionally single-threaded per connection: the device
executes one program at a time anyway, and in-order request handling keeps
the engine cache warm without locking.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import struct
import threading

import numpy as np

__all__ = ["EngineServer", "EngineClient", "serve"]

_HDR = struct.Struct("<I")


def _send(sock, header: dict, blocks: list[np.ndarray]) -> None:
    header = dict(header)
    header["payload"] = [[f"b{i}", str(b.dtype), list(b.shape)]
                         for i, b in enumerate(blocks)]
    raw = json.dumps(header).encode("utf-8")
    sock.sendall(_HDR.pack(len(raw)) + raw)
    for b in blocks:
        # zero-copy: hand the kernel a view of the array's buffer instead
        # of materializing a bytes copy (tape payloads are tens of MB)
        sock.sendall(memoryview(np.ascontiguousarray(b)).cast("B"))


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed mid-message")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv(sock) -> tuple[dict, dict[str, np.ndarray]]:
    (hlen,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    header = json.loads(_recv_exact(sock, hlen))
    blocks = {}
    for name, dtype, shape in header.get("payload", []):
        dt = np.dtype(dtype)
        count = int(np.prod(shape)) if shape else 1
        blocks[name] = np.frombuffer(
            _recv_exact(sock, count * dt.itemsize), dtype=dt).reshape(shape)
    return header, blocks


def _tape(blocks: dict, name: str) -> "Tape":
    from .ops.tape import Tape

    return Tape(np.asarray(blocks[f"{name}_data"], dtype=np.uint8),
                np.asarray(blocks[f"{name}_offsets"], dtype=np.int64))


class EngineServer:
    """Holds jitted engines warm and serves them on a Unix socket."""

    #: Engine-cache capacity. NW/SW cache keys embed the full byte→class +
    #: cost-table bytes, so an adversarial client cycling tables could grow
    #: the cache (and the jit caches behind each engine) without bound — the
    #: LRU bound caps worker memory at a few dozen warm engines.
    MAX_CACHED_ENGINES = 32

    def __init__(self, path: str):
        self.path = path
        from collections import OrderedDict

        self._engines: "OrderedDict[tuple, object]" = OrderedDict()
        self._server: socketserver.UnixStreamServer | None = None

    # --- engine cache (bounded LRU) -----------------------------------------

    def _engine(self, key: tuple, make):
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = make()
            while len(self._engines) > self.MAX_CACHED_ENGINES:
                self._engines.popitem(last=False)
        else:
            self._engines.move_to_end(key)
        return eng

    # --- op handlers ------------------------------------------------------

    def _handle(self, header: dict, blocks: dict) -> list[np.ndarray]:
        from . import (Fingerprints, LevenshteinDistances,
                       LevenshteinDistancesUTF8, NeedlemanWunschScores,
                       SmithWatermanScores)

        op = header["op"]
        if op in ("levenshtein", "levenshtein_utf8"):
            cls = (LevenshteinDistancesUTF8 if op.endswith("utf8")
                   else LevenshteinDistances)
            eng = self._engine((op,), cls)
            out = eng(_tape(blocks, "queries"), _tape(blocks, "candidates"))
            return [np.asarray(out)]
        if op in ("needleman_wunsch", "smith_waterman"):
            cls = (NeedlemanWunschScores if op == "needleman_wunsch"
                   else SmithWatermanScores)
            b2c = np.asarray(blocks["byte_to_class"], dtype=np.uint8)
            table = np.asarray(blocks["costs"], dtype=np.int32)
            gap_open = int(header.get("open", -1))
            gap_extend = int(header.get("extend", -1))
            key = (op, b2c.tobytes(), table.tobytes(), gap_open, gap_extend)
            eng = self._engine(key, lambda: cls(
                byte_to_class=b2c, class_substitution_costs=table,
                open=gap_open, extend=gap_extend))
            out = eng(_tape(blocks, "queries"), _tape(blocks, "candidates"))
            return [np.asarray(out)]
        if op == "fingerprints":
            ndim = int(header.get("ndim", 256))
            eng = self._engine((op, ndim), lambda: Fingerprints(ndim=ndim))
            hashes, counts = eng(_tape(blocks, "texts"))
            return [hashes, counts]
        if op == "hash":
            from .ops.hash import hash_batch

            # Tape-native: the wire blocks already ARE the (data, offsets)
            # layout the native batch tier consumes — no per-item copies.
            return [hash_batch(_tape(blocks, "texts"),
                               seed=int(header.get("seed", 0)))]
        if op == "sha256":
            from .ops.sha256 import sha256_batch

            return [np.asarray(sha256_batch(_tape(blocks, "texts")))]
        raise ValueError(f"unknown op {op!r}")

    # --- lifecycle --------------------------------------------------------

    def serve_forever(self) -> None:
        handle = self._handle

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        header, blocks = _recv(self.request)
                    except (ConnectionError, struct.error):
                        return
                    try:
                        out = handle(header, blocks)
                        _send(self.request, {"ok": True}, out)
                    except Exception as exc:  # error crosses the wire, not the process
                        _send(self.request, {"ok": False, "error": str(exc)}, [])

        if os.path.exists(self.path):
            os.unlink(self.path)
        self._server = socketserver.UnixStreamServer(self.path, Handler)
        self._server.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        while not os.path.exists(self.path):
            pass
        return t

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()


class EngineClient:
    """Python reference client (any language can speak the same bytes)."""

    def __init__(self, path: str):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(path)

    def close(self) -> None:
        self._sock.close()

    @staticmethod
    def _pack_tape(name: str, items) -> dict[str, np.ndarray]:
        from .ops.tape import Tape

        if isinstance(items, Tape):  # zero-copy: already the wire layout
            return {f"{name}_offsets": np.ascontiguousarray(items.offsets,
                                                            dtype=np.int64),
                    f"{name}_data": np.ascontiguousarray(items.data,
                                                         dtype=np.uint8)}
        data = b"".join(bytes(x) if not isinstance(x, str) else x.encode("utf-8")
                        for x in items)
        offsets = np.zeros(len(items) + 1, dtype=np.int64)
        pos = 0
        for i, x in enumerate(items):
            pos += len(bytes(x) if not isinstance(x, str) else x.encode("utf-8"))
            offsets[i + 1] = pos
        return {f"{name}_offsets": offsets,
                f"{name}_data": np.frombuffer(data, dtype=np.uint8)}

    def call(self, op: str, *, tapes: dict | None = None,
             arrays: dict | None = None, **params) -> list[np.ndarray]:
        blocks: dict[str, np.ndarray] = {}
        for name, items in (tapes or {}).items():
            blocks.update(self._pack_tape(name, items))
        for name, arr in (arrays or {}).items():
            blocks[name] = np.asarray(arr)
        header = {"op": op, **params,
                  "payload": [[n, str(b.dtype), list(b.shape)]
                              for n, b in blocks.items()]}
        raw = json.dumps(header).encode("utf-8")
        self._sock.sendall(_HDR.pack(len(raw)) + raw)
        for b in blocks.values():
            self._sock.sendall(np.ascontiguousarray(b).tobytes())
        resp, out = _recv(self._sock)
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "server error"))
        return [out[n] for n, _, _ in resp["payload"]]


def serve(path: str = "/tmp/stringzilla_tpu.sock") -> None:
    """CLI entry: ``python -m stringzilla_tpu.serve [socket-path]``."""
    EngineServer(path).serve_forever()


if __name__ == "__main__":
    import sys

    serve(sys.argv[1] if len(sys.argv) > 1 else "/tmp/stringzilla_tpu.sock")
