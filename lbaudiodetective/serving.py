"""Serving edge: the essay's "Whistles" identification server analog.

The reference project shipped a client/server split where the iOS app
uploads a recording and the server matches it against a fingerprint DB
keyed by bird (essay PDF §3.2.5, Table 3) over HTTP/JSON.  SURVEY §5 keeps
RPC out of the core: this module is a thin stdlib-HTTP edge over
:class:`~lbaudiodetective.models.library.FingerprintLibrary` — decode
and extraction run through the normal device pipeline, the library match is
one device dispatch per request.

Endpoints (JSON unless noted):
  GET  /healthz               -> {"ok": true, "tracks": N}
  POST /identify              body: raw CAF or WAV bytes
                              -> {"track": name, "score": s, "scores": {...}}
                              (libraries above ``search_threshold``: the
                              exact top-k "top" list replaces "scores")
  POST /fingerprint           body: raw CAF or WAV bytes
                              -> {"n": count, "fingerprint": "0110...+..."}
  POST /identify-fingerprint  body: fingerprint string ("0110...+...") —
                              the essay's actual protocol (the phone
                              fingerprints locally, the server only
                              matches); match-only, no extraction dispatch
  POST /stream/open           -> {"session": id} — live-recognition session
  POST /stream/<id>           body: fingerprint string of the NEW
                              subfingerprints since the last post ->
                              running {"track", "score", "top", "n"};
                              scores are EXACTLY the full rematch of the
                              accumulated fingerprint (incremental
                              diagonal state, O(new subs) per post)
  GET  /stream/<id>           peek the running result without posting
  POST /stream/<id>/close     final result; frees the session state

No third-party dependencies (stdlib ``http.server``); thread-safe because
the library is immutable after construction and JAX dispatch is serialised
per process.
"""

from __future__ import annotations

import json
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.io.decode import decode_audio_file
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.models.library import FingerprintLibrary
from lbaudiodetective.ops.extract import extract_fingerprint
from lbaudiodetective import errors


class IdentificationService:
    """Pure request->response core (testable without sockets).

    ``batch_window_s > 0`` enables identify micro-batching: concurrent
    requests landing within the window (or until ``max_batch``) are
    extracted in ONE padded device dispatch by the first-arriving thread
    (the batch leader), then matched and distributed — the
    production-serving answer to per-request dispatch overhead on the
    accelerator.  Results are identical to the unbatched path
    (extract_fingerprint_batch is bit-identical to per-clip extraction;
    tests/test_serving.py).

    ``search_threshold`` selects the matching strategy by library size:
    at or below it, brute-force scores for EVERY track are returned
    (the ``"scores"`` dict); above it, the two-stage coarse->exact
    search returns only the ``"top"`` list of ``top_k`` candidates with
    exact scores (a 1M-track response cannot enumerate every track).
    """

    def __init__(self, library: FingerprintLibrary, names: list[str],
                 config: FingerprintConfig | None = None,
                 batch_window_s: float = 0.0, max_batch: int = 8,
                 search_threshold: int = 4096, top_k: int = 5,
                 n_sub_cap: int = 0, stream_cap: int = 256,
                 max_sessions: int = 64, stream_library_max: int = 65536,
                 stream_idle_evict_s: float = 30.0,
                 stream_pool: bool = False,
                 stream_flush_window_s: float = 0.02):
        if len(names) != len(library):
            raise errors.InvalidArgumentError("names must match library size")
        self.library = library
        self.names = list(names)
        self.config = config or FingerprintConfig()
        # Serving is an identification edge: refuse silence about precision
        # tiers whose identified counts diverge from the corpus goldens.
        self.config.warn_if_unvalidated_for_identification()
        self._lock = threading.Lock()
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self._bcond = threading.Condition()
        self._pending: list[dict] = []
        self.search_threshold = search_threshold
        self.top_k = top_k
        #: >0 pins every batched extraction to ONE static shape (batch axis
        #: padded to max_batch, subfingerprint bucket fixed at the cap; clips
        #: beyond the cap truncate) — one jit compilation for the lifetime of
        #: the server instead of one per (batch size, length bucket) pair.
        self.n_sub_cap = n_sub_cap
        #: Number of extraction device dispatches (observability + tests).
        self.extract_dispatches = 0
        # Live-recognition streaming sessions (see stream_open below).
        self.stream_cap = stream_cap
        self.max_sessions = max_sessions
        #: Largest library live-recognition sessions are served against: the
        #: incremental matcher holds UNPACKED [L, S, pairs] device planes
        #: (16x the packed size; ~12.8 GB at 1M tracks) plus per-session
        #: L x (S + stream_cap) f32 diagonals, so one unauthenticated
        #: /stream/open against a search-scale library would OOM the chip.
        #: Past the bound, opens are refused with a typed 429.
        self.stream_library_max = stream_library_max
        #: A session is evictable once idle this long; /stream/open never
        #: destroys an actively-posting session (it 429s instead).
        self.stream_idle_evict_s = stream_idle_evict_s
        self._slock = threading.Lock()
        self._sessions: dict[str, dict] = {}
        self._template = None
        #: Pooled sessions: all sessions share one slot-batched matcher
        #: (streaming/incremental.py::StreamSessionPool) and concurrent
        #: posts arriving within ``stream_flush_window_s`` fold in ONE
        #: device dispatch + ONE top-k, instead of two dispatches per post
        #: — the same micro-batching identify uses, applied to live
        #: sessions.  Per-slot scores are bitwise equal to the default
        #: per-session matchers.
        self.stream_pool = stream_pool
        self.stream_flush_window_s = stream_flush_window_s
        self._pool = None
        self._pcond = threading.Condition()
        self._ppending: list[dict] = []

    @property
    def _use_search(self) -> bool:
        return len(self.library) > self.search_threshold

    def _decode_bytes(self, payload: bytes):
        suffix = (".caf" if payload[:4] == b"caff"
                  else ".aiff" if payload[:4] == b"FORM"
                  else ".au" if payload[:4] == b".snd" else ".wav")
        with tempfile.NamedTemporaryFile(suffix=suffix) as f:
            f.write(payload)
            f.flush()
            return decode_audio_file(f.name)

    def _count_dispatch(self) -> None:
        with self._lock:                 # += on a counter is not atomic
            self.extract_dispatches += 1

    def _fingerprint_bytes(self, payload: bytes) -> Fingerprint:
        decoded = self._decode_bytes(payload)
        pos, neg, n = extract_fingerprint(decoded, self.config)
        self._count_dispatch()
        return Fingerprint.from_planes(np.asarray(pos[:n]), np.asarray(neg[:n]),
                                       self.config.subfingerprint_length)

    def _respond(self, fp: Fingerprint) -> dict:
        if fp.num_subfingerprints == 0:
            raise errors.DecodeError("clip too short to fingerprint")
        if self._use_search:
            with self._lock:
                idx, scores = self.library.search(fp, top_k=self.top_k)
            return self._response_from_topk(idx, scores)
        with self._lock:            # one device dispatch per request
            scores = self.library.match(fp)
        best = int(np.argmax(scores))
        return {"track": self.names[best], "score": float(scores[best]),
                "scores": {n: float(s) for n, s in zip(self.names, scores)}}

    def _response_from_topk(self, idx, scores) -> dict:
        return {"track": self.names[int(idx[0])], "score": float(scores[0]),
                "top": [{"track": self.names[int(i)], "score": float(s)}
                        for i, s in zip(idx, scores)]}

    def identify(self, payload: bytes) -> dict:
        if self.batch_window_s <= 0:
            return self._respond(self._fingerprint_bytes(payload))
        return self._identify_batched(payload)

    def identify_fingerprint(self, payload: bytes) -> dict:
        """Identify from an uploaded FINGERPRINT (string golden form).

        The essay's actual client/server division of labour (PDF §3.2.5):
        the iPhone fingerprints locally and uploads the fingerprint; the
        server only matches.  Match-only path — no decode or extraction
        dispatch happens server-side.  A consistent-but-wrong
        per-subfingerprint length would fail deep in the packed matcher as
        an opaque 500, so the parser rejects it up front.
        """
        return self._respond(self._parse_fingerprint_text(payload))

    # -- micro-batching -----------------------------------------------------

    def _identify_batched(self, payload: bytes) -> dict:
        decoded = self._decode_bytes(payload)    # decode stays per-thread
        entry = {"clip": decoded, "done": threading.Event(),
                 "fp": None, "error": None}
        with self._bcond:
            self._pending.append(entry)
            is_leader = len(self._pending) == 1
            if len(self._pending) >= self.max_batch:
                self._bcond.notify_all()         # wake the leader early
        if is_leader:
            with self._bcond:
                self._bcond.wait_for(
                    lambda: len(self._pending) >= self.max_batch,
                    timeout=self.batch_window_s)
                batch, self._pending = self._pending, []
            # max_batch bounds the fused dispatch (padded device memory /
            # latency), not just the wakeup: a burst larger than max_batch
            # is processed in chunks — every taken entry IS processed here,
            # so no follower can be left waiting.
            for start in range(0, len(batch), self.max_batch):
                self._run_batch(batch[start:start + self.max_batch])
        else:
            entry["done"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        if entry.get("topk") is not None:       # searched in the batch
            return self._response_from_topk(*entry["topk"])
        if entry.get("scores") is not None:     # matched in the batch
            return self._response_from_scores(entry["scores"])
        return self._respond(entry["fp"])

    def _response_from_scores(self, scores: np.ndarray) -> dict:
        best = int(np.argmax(scores))
        return {"track": self.names[best], "score": float(scores[best]),
                "scores": {n: float(s) for n, s in zip(self.names, scores)}}

    def _run_batch(self, batch: list[dict]) -> None:
        from lbaudiodetective.ops.extract import (extract_fingerprint,
                                                  extract_fingerprint_batch)

        try:
            pos, neg, n_subs = extract_fingerprint_batch(
                [e["clip"] for e in batch], self.config,
                pad_batch_to=self.max_batch if self.n_sub_cap else 0,
                n_sub_cap=self.n_sub_cap)
            self._count_dispatch()
            for i, e in enumerate(batch):
                n = int(n_subs[i])
                e["fp"] = Fingerprint.from_planes(
                    pos[i, :n], neg[i, :n], self.config.subfingerprint_length)
            # Match the whole batch in ONE vmapped dispatch too (clips too
            # short to fingerprint are excluded; they raise DecodeError in
            # their own thread via the _respond fallback).
            matchable = [e for e in batch
                         if e["fp"].num_subfingerprints > 0]
            if matchable:
                fps_m = [e["fp"] for e in matchable]
                if self.n_sub_cap and len(fps_m) < self.max_batch:
                    # Static shapes extend to the match stage: pad the query
                    # batch with empty fingerprints (count 0 scores 0 and is
                    # dropped below) so every batch hits one matcher compile.
                    pairs = fps_m[0].pairs
                    empty = Fingerprint.from_planes(
                        np.zeros((0, pairs), np.uint8),
                        np.zeros((0, pairs), np.uint8),
                        self.config.subfingerprint_length)
                    fps_m = fps_m + [empty] * (self.max_batch - len(fps_m))
                if self._use_search:
                    with self._lock:
                        idx, sc = self.library.search_many(
                            fps_m, top_k=self.top_k)
                    for i, e in enumerate(matchable):
                        e["topk"] = (idx[i], sc[i])
                else:
                    with self._lock:
                        all_scores = self.library.match_many(fps_m)
                    for e, s in zip(matchable, all_scores):
                        e["scores"] = s
        except Exception:  # noqa: BLE001 — isolate the failing clip(s):
            # re-run each clip individually so one pathological request
            # (e.g. a huge clip OOM-ing the padded batch) fails only itself,
            # matching the unbatched path's per-request isolation.
            for e in batch:
                try:
                    p1, n1, n = extract_fingerprint(e["clip"], self.config)
                    self._count_dispatch()
                    e["fp"] = Fingerprint.from_planes(
                        np.asarray(p1[:n]), np.asarray(n1[:n]),
                        self.config.subfingerprint_length)
                except Exception as exc_one:  # noqa: BLE001
                    e["error"] = exc_one
        finally:
            for e in batch:
                e["done"].set()

    def fingerprint(self, payload: bytes) -> dict:
        fp = self._fingerprint_bytes(payload)
        return {"n": fp.num_subfingerprints, "fingerprint": fp.to_string()}

    def health(self) -> dict:
        return {"ok": True, "tracks": len(self.library)}

    # -- live-recognition streaming sessions ---------------------------------
    #
    # The essay's Whistles loop as a server protocol: the phone fingerprints
    # locally and posts only the NEW subfingerprints of its ongoing recording;
    # the server folds them into per-session incremental diagonal state
    # (streaming/incremental.py) and answers with the running best match —
    # exactly what a full rematch of the accumulated fingerprint would score,
    # at O(new subs) device work per post.  State per session is
    # L x (S + stream_cap) f32 diagonals (~18 MB at 16k tracks, cap 256),
    # so sessions are capped and idle ones evicted LRU.

    def _parse_fingerprint_text(self, payload: bytes) -> Fingerprint:
        try:
            text = payload.decode("ascii")
        except UnicodeDecodeError as e:
            raise errors.InvalidArgumentError(
                f"fingerprint payload is not ASCII: {e}") from None
        text = text.strip()
        if text and set(text) - set("01+"):
            raise errors.InvalidArgumentError(
                "fingerprint string may contain only '0', '1' and '+'")
        first = text.split("+", 1)[0] if text else ""
        if first and len(first) != self.config.subfingerprint_length:
            raise errors.InvalidArgumentError(
                f"fingerprint subfingerprint length {len(first)} does not "
                f"match server config ({self.config.subfingerprint_length})")
        try:
            return Fingerprint.from_string(
                text, self.config.subfingerprint_length)
        except ValueError as e:                 # ragged subfingerprints
            raise errors.InvalidArgumentError(str(e)) from None

    def stream_open(self) -> dict:
        import time
        import uuid

        if len(self.library) > self.stream_library_max:
            raise errors.ResourceExhaustedError(
                f"live-recognition sessions are limited to libraries of "
                f"<= {self.stream_library_max} tracks (this one has "
                f"{len(self.library)}); use /identify-fingerprint")
        with self._slock:
            self._ensure_template()
            if len(self._sessions) >= self.max_sessions:
                # Evict the least-recently-used session, but only if it is
                # genuinely idle — an at-capacity server full of live
                # streams refuses new opens rather than silently destroying
                # an active client's accumulated state.
                victim = min(self._sessions, key=lambda k:
                             self._sessions[k]["t"])
                if (time.monotonic() - self._sessions[victim]["t"]
                        < self.stream_idle_evict_s):
                    raise errors.ResourceExhaustedError(
                        f"all {self.max_sessions} session slots hold "
                        "active streams; retry shortly")
                del self._sessions[victim]
                if self.stream_pool:
                    with self._pcond:
                        self._pool.close(victim)
            sid = uuid.uuid4().hex[:16]
            sess = {"t": time.monotonic(), "lock": threading.Lock()}
            if self.stream_pool:
                with self._pcond:
                    self._pool.open(sid)
            else:
                sess["m"] = self._template.clone_empty()
            self._sessions[sid] = sess
        return {"session": sid}

    def _stream_session(self, sid: str) -> dict:
        with self._slock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise errors.InvalidArgumentError(f"unknown session {sid!r}")
        return sess

    def stream_update(self, sid: str, payload: bytes) -> dict:
        import time

        sess = self._stream_session(sid)
        fp = self._parse_fingerprint_text(payload)
        k = fp.num_subfingerprints
        if self.stream_pool:
            return self._stream_update_pooled(sess, sid, fp, k)
        with sess["lock"]:
            m = sess["m"]
            if k:
                if m.n + k > m.n_cap:
                    raise errors.InvalidArgumentError(
                        f"stream age {m.n + k} exceeds the session cap "
                        f"({m.n_cap}); close and re-open")
                # Bucketed: k is a static jit shape; live clients post
                # uneven increments, so raw-k updates would compile one
                # kernel per distinct increment size.
                m.update_bucketed(np.asarray(fp.pos)[None],
                                  np.asarray(fp.neg)[None])
            sess["t"] = time.monotonic()
            return self._stream_result(m)

    def _stream_update_pooled(self, sess: dict, sid: str, fp, k: int) -> dict:
        """Pooled post: queue the increment, then fold EVERY queued post in
        one batched dispatch (leader/follower over
        ``stream_flush_window_s``, the micro-batching identify uses) and
        answer all waiters from one device-side top-k."""
        import time

        entry = {"sid": sid, "done": threading.Event(), "error": None,
                 "result": None}
        with self._pcond:
            if sid not in self._pool._slot:
                raise errors.InvalidArgumentError(f"unknown session {sid!r}")
            if k:
                age = self._pool.age(sid) + self._pool.pending(sid)
                if age + k > self.stream_cap:
                    raise errors.InvalidArgumentError(
                        f"stream age {age + k} exceeds the session cap "
                        f"({self.stream_cap}); close and re-open")
                self._pool.post(sid, np.asarray(fp.pos), np.asarray(fp.neg))
            self._ppending.append(entry)
            is_leader = len(self._ppending) == 1
            if len(self._ppending) >= self.max_sessions:
                self._pcond.notify_all()         # wake the leader early
        if is_leader:
            with self._pcond:
                if self.stream_flush_window_s > 0:
                    # Release the lock for the window so concurrent posts
                    # can join this flush; a full window (every slot has a
                    # pending post) wakes the leader early.
                    self._pcond.wait_for(
                        lambda: len(self._ppending) >= self.max_sessions,
                        timeout=self.stream_flush_window_s)
                batch, self._ppending = self._ppending, []
                try:
                    self._pool.flush()
                    sc, ix = self._pool.top_k(self.top_k)
                    for en in batch:
                        slot = self._pool._slot.get(en["sid"])
                        if slot is None:            # closed while queued
                            en["error"] = errors.InvalidArgumentError(
                                f"unknown session {en['sid']!r}")
                        else:
                            en["result"] = self._pool_result(
                                en["sid"], sc[slot], ix[slot])
                except Exception as e:  # noqa: BLE001 — fail all waiters
                    for en in batch:
                        if en["error"] is None and en["result"] is None:
                            en["error"] = e
                finally:
                    for en in batch:
                        en["done"].set()
        else:
            entry["done"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        sess["t"] = time.monotonic()
        return entry["result"]

    def _pool_result(self, sid: str, sc: np.ndarray, ix: np.ndarray) -> dict:
        n = self._pool.age(sid)
        if n == 0:
            return {"track": None, "score": 0.0, "top": [], "n": 0}
        return {"track": self.names[int(ix[0])], "score": float(sc[0]),
                "top": [{"track": self.names[int(i)],
                         "score": float(s)} for i, s in zip(ix, sc)],
                "n": n}

    def _stream_result(self, m) -> dict:
        if m.n == 0:
            return {"track": None, "score": 0.0, "top": [], "n": 0}
        # Device-side top-k: fetch self.top_k winners per post, not the
        # full [L] score plane (ties resolve lowest-index, matching a
        # stable descending sort).
        sc, ix = m.top_k(self.top_k)
        sc, ix = sc[0], ix[0]
        return {"track": self.names[int(ix[0])],
                "score": float(sc[0]),
                "top": [{"track": self.names[int(i)],
                         "score": float(s)} for i, s in zip(ix, sc)],
                "n": int(m.n)}

    def _ensure_template(self) -> None:
        """Lazily build the per-library incremental-matcher template the
        per-session clones share (callers hold ``_slock``)."""
        if self.stream_pool:
            if self._pool is None:
                from lbaudiodetective.streaming.incremental import (
                    StreamSessionPool)

                self._pool = StreamSessionPool(
                    self.library, slots=self.max_sessions,
                    n_cap=self.stream_cap, config=self.config)
            return
        if self._template is None:
            from lbaudiodetective.streaming.incremental import (
                IncrementalLibraryMatcher)

            self._template = IncrementalLibraryMatcher(
                self.library, batch=1, n_cap=self.stream_cap,
                config=self.config)

    def save_sessions(self, dir_path: str) -> int:
        """Checkpoint every live session's incremental state (one npz per
        session) so a server restart does not lose streams whose audio
        only ever existed as posted increments.  Returns the count.
        Checkpoints of sessions no longer live (closed/evicted since the
        last save) are removed — the directory always mirrors the current
        session table."""
        import os

        os.makedirs(dir_path, exist_ok=True)
        with self._slock:
            items = list(self._sessions.items())
        live = {f"{sid}.npz" for sid, _ in items}
        for fname in os.listdir(dir_path):
            if fname.endswith(".npz") and fname not in live:
                os.unlink(os.path.join(dir_path, fname))
        n = 0
        if self.stream_pool:
            with self._pcond:
                self._pool.flush()      # pending posts become device state
                for sid, _ in items:
                    self._pool.save_session(
                        sid, os.path.join(dir_path, f"{sid}.npz"))
                    n += 1
            return n
        for sid, sess in items:
            with sess["lock"]:
                sess["m"].save_state(os.path.join(dir_path, f"{sid}.npz"))
            n += 1
        return n

    def load_sessions(self, dir_path: str) -> int:
        """Restore sessions saved by :meth:`save_sessions` against the SAME
        library (state-key checked per file).  Returns the count.
        Unreadable or mismatched checkpoints (library re-enrolled, file
        truncated by a crash) are skipped with a warning — one bad file
        must not keep the server from booting."""
        import os
        import sys
        import time

        count = 0
        with self._slock:
            self._ensure_template()
            for fname in sorted(os.listdir(dir_path)):
                if not fname.endswith(".npz"):
                    continue
                if len(self._sessions) >= self.max_sessions:
                    break
                sid = fname[:-4]
                sess = {"t": time.monotonic(), "lock": threading.Lock()}
                try:
                    if self.stream_pool:
                        with self._pcond:
                            self._pool.open(sid)
                            try:
                                self._pool.restore_session(
                                    sid, os.path.join(dir_path, fname))
                            except Exception:
                                self._pool.close(sid)
                                raise
                    else:
                        m = self._template.clone_empty()
                        m.restore_state(os.path.join(dir_path, fname))
                        sess["m"] = m
                except Exception as e:  # noqa: BLE001 — skip, don't brick boot
                    print(f"skipping session checkpoint {fname}: {e}",
                          file=sys.stderr)
                    continue
                self._sessions[sid] = sess
                count += 1
        return count

    def stream_peek(self, sid: str) -> dict:
        """Current running result of a session without posting new
        subfingerprints (``GET /stream/<id>``).  Counts as activity — a
        client polling between posts must not become LRU-evictable."""
        import time

        sess = self._stream_session(sid)
        if self.stream_pool:
            with self._pcond:
                if sid not in self._pool._slot:
                    raise errors.InvalidArgumentError(
                        f"unknown session {sid!r}")
                self._pool.flush()      # fold this session's queued posts
                slot = self._pool._slot[sid]
                sc, ix = self._pool.top_k(self.top_k)
                sess["t"] = time.monotonic()
                return self._pool_result(sid, sc[slot], ix[slot])
        with sess["lock"]:
            sess["t"] = time.monotonic()
            return self._stream_result(sess["m"])

    def stream_close(self, sid: str) -> dict:
        with self._slock:
            sess = self._sessions.pop(sid, None)
        if sess is None:
            raise errors.InvalidArgumentError(f"unknown session {sid!r}")
        if self.stream_pool:
            with self._pcond:
                if sid not in self._pool._slot:
                    raise errors.InvalidArgumentError(
                        f"unknown session {sid!r}")
                self._pool.flush()      # fold any queued posts first
                slot = self._pool._slot[sid]
                sc, ix = self._pool.top_k(self.top_k)
                result = self._pool_result(sid, sc[slot], ix[slot])
                self._pool.close(sid)
                return result
        with sess["lock"]:
            return self._stream_result(sess["m"])


def make_server(service: IdentificationService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``server.server_address[1]`` is the
    bound port (ephemeral when ``port=0``)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/healthz":
                    self._send(200, service.health())
                elif self.path.startswith("/stream/"):
                    sid = self.path[len("/stream/"):]
                    self._send(200, service.stream_peek(sid))
                else:
                    self._send(404, {"error": "not found"})
            except errors.AudioDetectiveError as e:
                self._send(400, {"error": str(e), "status": e.status})
            except Exception as e:  # noqa: BLE001 — serving edge must not die
                self._send(500, {"error": str(e)})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = self.rfile.read(length)
                if self.path == "/identify":
                    self._send(200, service.identify(payload))
                elif self.path == "/identify-fingerprint":
                    self._send(200, service.identify_fingerprint(payload))
                elif self.path == "/fingerprint":
                    self._send(200, service.fingerprint(payload))
                elif self.path == "/stream/open":
                    self._send(200, service.stream_open())
                elif (self.path.startswith("/stream/")
                      and self.path.endswith("/close")):
                    sid = self.path[len("/stream/"):-len("/close")]
                    self._send(200, service.stream_close(sid))
                elif self.path.startswith("/stream/"):
                    sid = self.path[len("/stream/"):]
                    self._send(200, service.stream_update(sid, payload))
                else:
                    self._send(404, {"error": "not found"})
            except errors.ResourceExhaustedError as e:
                self._send(429, {"error": str(e), "status": e.status})
            except errors.AudioDetectiveError as e:
                self._send(400, {"error": str(e), "status": e.status})
            except Exception as e:  # noqa: BLE001 — serving edge must not die
                self._send(500, {"error": str(e)})

        def log_message(self, *a):  # quiet test output
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(service: IdentificationService, host: str = "0.0.0.0",
                  port: int = 8080) -> None:  # pragma: no cover - CLI entry
    server = make_server(service, host, port)
    server.serve_forever()
