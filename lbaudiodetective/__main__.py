"""Command-line interface: ``python -m lbaudiodetective <cmd> ...``.

The reference ships as an iOS library driven by a test app; the essay's
workflow is enroll-then-identify against a server DB (PDF §3.2.5).  This CLI
exposes that workflow on top of the library APIs:

  fingerprint <clip>                      print the fingerprint string form
  compare <clip1> <clip2>                 print the match score
  enroll <dir> -o lib.npz                 build a library from a directory
  identify <clip> --library lib.npz       best match + per-track scores
  dedup --library lib.npz                 all-pairs near-duplicate scan
  serve --library lib.npz --names ...     run the HTTP identification edge
  client <clip> --url http://host:8414    POST a clip to a running server

Audio: CAF (IMA4/LPCM), WAV, and AIFF/AIFF-C.  Library files are the
utils.serialize format (parameter-hash guarded).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _detective():
    from lbaudiodetective.models.detective import AudioDetective

    return AudioDetective()


def _extract(path: str):
    det = _detective()
    return det.process_audio_file(path), det.config


def _audio_files(directory: str) -> list[pathlib.Path]:
    exts = {".caf", ".wav", ".aiff", ".aif", ".aifc", ".au", ".snd"}
    return sorted(p for p in pathlib.Path(directory).iterdir()
                  if p.suffix.lower() in exts)


def cmd_fingerprint(args) -> int:
    fp, _ = _extract(args.clip)
    print(fp.to_string())
    return 0


def cmd_compare(args) -> int:
    if args.algorithm == "maa":
        # The essay's rejected predecessor (models/maa.py): reports a match
        # COUNT, not a score in [0,1] (essay §4.1.1).
        from lbaudiodetective.models.maa import maa_compare_audio_files

        print(maa_compare_audio_files(args.clip1, args.clip2))
        return 0
    det = _detective()
    score = det.compare_audio_files(args.clip1, args.clip2)
    print(f"{score:.4f}")
    return 0


def cmd_enroll(args) -> int:
    from lbaudiodetective.models.library import FingerprintLibrary

    files = _audio_files(args.directory)
    if not files:
        print(f"no audio files in {args.directory}", file=sys.stderr)
        return 2
    det = _detective()
    fps = det.process_batch([str(f) for f in files])  # one padded dispatch
    names = [f.stem for f in files]
    for f, fp in zip(files, fps):
        print(f"enrolled {f.stem}: {fp.num_subfingerprints} subfingerprints",
              file=sys.stderr)
    # np.savez appends '.npz' when missing: normalise first so the .names.json
    # sidecar sits next to the file actually written and `identify --library`
    # finds it under the same name the user passed + '.npz'.
    out_path = args.output if args.output.endswith(".npz") else args.output + ".npz"
    names_path = pathlib.Path(out_path).with_suffix(".names.json")
    if getattr(args, "append", False) and pathlib.Path(out_path).exists():
        # Incremental enrollment: grow an existing library in place (the
        # parameter-hash guard refuses libraries from other configs).
        lib = FingerprintLibrary.load(out_path, det.config).extend(fps)
        old_names = (json.loads(names_path.read_text())
                     if names_path.exists()
                     else [f"track_{i}" for i in range(len(lib) - len(fps))])
        names = old_names + names
    else:
        lib = FingerprintLibrary.from_fingerprints(fps, det.config)
    lib.save(out_path)
    names_path.write_text(json.dumps(names))
    print(f"wrote {out_path} ({len(lib)} tracks)", file=sys.stderr)
    return 0


def _load_library(path: str):
    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.models.library import FingerprintLibrary

    # Passing the config arms the parameter-hash guard: a library enrolled
    # under different parameters refuses to load instead of silently
    # producing meaningless scores.
    lib = FingerprintLibrary.load(path, FingerprintConfig())
    names_file = pathlib.Path(path).with_suffix(".names.json")
    if names_file.exists():
        names = json.loads(names_file.read_text())
        if len(names) != len(lib):
            raise SystemExit(
                f"{names_file} has {len(names)} names for {len(lib)} tracks"
                " — stale sidecar?")
    else:
        names = [f"track_{i}" for i in range(len(lib))]
    return lib, names


def cmd_identify(args) -> int:
    import numpy as np

    if args.top_k < 0:
        print("--top-k must be non-negative", file=sys.stderr)
        return 2
    lib, names = _load_library(args.library)
    fp, _ = _extract(args.clip)
    if args.top_k:
        idx, sc = lib.search(fp, top_k=args.top_k)
        out = {"track": names[int(idx[0])], "score": round(float(sc[0]), 4),
               "top": [{"track": names[int(i)], "score": round(float(s), 4)}
                       for i, s in zip(idx, sc)]}
        print(json.dumps(out))
        return 0
    scores = np.asarray(lib.match(fp))
    best = int(scores.argmax())
    out = {"track": names[best], "score": round(float(scores[best]), 4)}
    if args.all_scores:
        out["scores"] = {n: round(float(s), 4) for n, s in zip(names, scores)}
    print(json.dumps(out))
    return 0


def cmd_dedup(args) -> int:
    """All-pairs near-duplicate scan of an enrolled library.

    Runs the packed ring dedup (parallel.sharded_packed.ring_dedup_topk_packed
    — BASELINE config 5's candidate exchange) over a ``--devices``-way library
    ring (1 device = plain all-pairs) and prints each track's top-k candidate
    matches, optionally filtered by ``--threshold``.
    """
    import numpy as np

    from lbaudiodetective.parallel.mesh import make_mesh
    from lbaudiodetective.parallel.sharded_packed import (
        ring_dedup_topk_packed)

    if args.top_k < 1:
        print("--top-k must be >= 1", file=sys.stderr)
        return 2
    if args.devices < 1:
        print("--devices must be >= 1", file=sys.stderr)
        return 2
    lib, names = _load_library(args.library)
    l_real = len(lib)
    if l_real < 2:
        print("library has fewer than 2 tracks — nothing to dedup",
              file=sys.stderr)
        return 2
    mesh = make_mesh(n_devices=args.devices,
                     library_parallelism=args.devices)
    ring = mesh.shape["library"]
    pad = (-l_real) % ring
    pos, neg, counts = (np.asarray(lib.pos_words), np.asarray(lib.neg_words),
                        np.asarray(lib.counts))
    if pad:
        pos = np.pad(pos, ((0, pad), (0, 0), (0, 0)))
        neg = np.pad(neg, ((0, pad), (0, 0), (0, 0)))
        counts = np.pad(counts, (0, pad))
    # Pad entries rank at score 0.0 inside the device top-k; request `pad`
    # extra slots so they can never displace a real candidate, then filter
    # them from the output.
    k = min(args.top_k, l_real - 1)
    k_dev = min(k + pad, l_real + pad - 1)
    scores, idx = ring_dedup_topk_packed(
        pos, neg, counts, lib.pairs, mesh, k=k_dev,
        subfingerprint_length=lib.config.subfingerprint_length)
    scores, idx = np.asarray(scores)[:l_real], np.asarray(idx)[:l_real]
    out = []
    for t in range(l_real):
        cands = [{"track": names[int(j)], "score": round(float(s), 4)}
                 for s, j in zip(scores[t], idx[t])
                 if 0 <= int(j) < l_real and float(s) >= args.threshold][:k]
        if cands:
            out.append({"track": names[t], "candidates": cands})
    print(json.dumps(out, indent=None if args.compact else 2))
    return 0


def cmd_serve(args) -> int:
    from lbaudiodetective.serving import (IdentificationService,
                                          serve_forever)

    lib, names = _load_library(args.library)
    shard_note = ""
    if args.shard_library:
        from lbaudiodetective.parallel.mesh import make_mesh
        from lbaudiodetective.parallel.sharded_library import (
            ShardedFingerprintLibrary)

        mesh = make_mesh(library_parallelism=args.shard_library or None)
        lib = ShardedFingerprintLibrary(lib, mesh)
        shard_note = f" ({mesh.shape['library']}-way library-sharded)"
    service = IdentificationService(
        lib, names, batch_window_s=args.batch_window,
        max_batch=args.max_batch, n_sub_cap=args.n_sub_cap,
        search_threshold=args.search_threshold, top_k=args.top_k,
        stream_pool=args.stream_pool,
        stream_flush_window_s=args.stream_flush_window)
    if args.sessions_dir and pathlib.Path(args.sessions_dir).is_dir():
        n = service.load_sessions(args.sessions_dir)
        if n:
            print(f"restored {n} live session(s) from {args.sessions_dir}",
                  file=sys.stderr)
    print(f"serving {len(names)} tracks on {args.host}:{args.port}"
          f"{shard_note}", file=sys.stderr)
    try:
        serve_forever(service, host=args.host, port=args.port)
    finally:
        # Checkpoint live sessions on shutdown (Ctrl-C included) so the
        # next boot with the same --sessions-dir resumes them.
        if args.sessions_dir:
            n = service.save_sessions(args.sessions_dir)
            print(f"saved {n} live session(s) to {args.sessions_dir}",
                  file=sys.stderr)
    return 0


def cmd_client(args) -> int:
    """The essay's app side of the client/server split (PDF §3.2.4-3.2.5):
    upload a recording, print the server's identification JSON."""
    import urllib.error
    import urllib.request

    if args.local_extract:
        # The essay's actual division of labour (PDF §3.2.5): the client
        # fingerprints locally and uploads the fingerprint string; the
        # server only matches.
        fp, _ = _extract(args.clip)
        payload = fp.to_string().encode("ascii")
        url = args.url.rstrip("/") + "/identify-fingerprint"
    else:
        with open(args.clip, "rb") as f:
            payload = f.read()
        url = args.url.rstrip("/") + ("/fingerprint" if args.fingerprint
                                      else "/identify")
    req = urllib.request.Request(url, data=payload)
    try:
        with urllib.request.urlopen(req, timeout=args.timeout) as r:
            print(r.read().decode())
        return 0
    except urllib.error.HTTPError as e:
        print(e.read().decode(), file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"cannot reach {args.url}: {e.reason}", file=sys.stderr)
        return 2


def cmd_listen(args) -> int:
    """Live recognition against a running server: fingerprint the clip
    locally, then stream it to ``/stream/<id>`` in increments the way the
    essay's app posts its ongoing recording — printing the running best
    match after every post (serving.py streaming sessions)."""
    import json as _json
    import urllib.error
    import urllib.request

    def post(path, payload=b""):
        req = urllib.request.Request(args.url.rstrip("/") + path,
                                     data=payload)
        with urllib.request.urlopen(req, timeout=args.timeout) as r:
            return _json.loads(r.read().decode())

    fp, _ = _extract(args.clip)
    subs = fp.to_string().split("+") if fp.num_subfingerprints else []
    try:
        sid = post("/stream/open")["session"]
        for i in range(0, len(subs), args.chunk):
            body = post(f"/stream/{sid}",
                        "+".join(subs[i:i + args.chunk]).encode("ascii"))
            print(f"[{body['n']:4d} subs] {body['track']} "
                  f"{body['score']:.4f}", file=sys.stderr)
        print(_json.dumps(post(f"/stream/{sid}/close")))
        return 0
    except urllib.error.HTTPError as e:
        print(e.read().decode(), file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"cannot reach {args.url}: {e.reason}", file=sys.stderr)
        return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lbaudiodetective",
                                description=__doc__.split("\n", 1)[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fingerprint", help="print a clip's fingerprint string")
    f.add_argument("clip")
    f.set_defaults(fn=cmd_fingerprint)

    c = sub.add_parser("compare", help="match score between two clips")
    c.add_argument("clip1")
    c.add_argument("clip2")
    c.add_argument("--algorithm", choices=("afa", "maa"), default="afa",
                   help="afa = the shipped fingerprinting algorithm; "
                        "maa = the essay's rejected predecessor "
                        "(prints a match count, not a score)")
    c.set_defaults(fn=cmd_compare)

    e = sub.add_parser("enroll", help="build a library from a directory")
    e.add_argument("directory")
    e.add_argument("-o", "--output", required=True)
    e.add_argument("--append", action="store_true",
                   help="add to an existing library instead of overwriting")
    e.set_defaults(fn=cmd_enroll)

    i = sub.add_parser("identify", help="identify a clip against a library")
    i.add_argument("clip")
    i.add_argument("--library", required=True)
    i.add_argument("--all-scores", action="store_true")
    i.add_argument("--top-k", type=int, default=0, metavar="K",
                   help="answer with the exact top-K via two-stage "
                        "coarse->exact search (large libraries)")
    i.set_defaults(fn=cmd_identify)

    d = sub.add_parser("dedup", help="all-pairs near-duplicate scan of a "
                                     "library (packed ring dedup)")
    d.add_argument("--library", required=True)
    d.add_argument("--top-k", type=int, default=3, metavar="K",
                   help="candidates reported per track (default 3)")
    d.add_argument("--threshold", type=float, default=0.0,
                   help="only report candidate pairs scoring >= this")
    d.add_argument("--devices", type=int, default=1, metavar="N",
                   help="ring size: shard the library over N devices")
    d.add_argument("--compact", action="store_true",
                   help="single-line JSON output")
    d.set_defaults(fn=cmd_dedup)

    s = sub.add_parser("serve", help="run the HTTP identification server")
    s.add_argument("--library", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8414)
    s.add_argument("--shard-library", type=int, default=0, metavar="N",
                   help="shard the library N-way over the device mesh "
                        "(multi-device hosts/pods; 0 = single device)")
    s.add_argument("--batch-window", type=float, default=0.0, metavar="S",
                   help="micro-batch concurrent identifies arriving within "
                        "S seconds into one device dispatch (0 = off)")
    s.add_argument("--max-batch", type=int, default=8)
    s.add_argument("--n-sub-cap", type=int, default=0, metavar="K",
                   help="pin batched extraction to static shapes (cap each "
                        "clip at K subfingerprints; one jit compile for the "
                        "server lifetime — recommended for serving)")
    s.add_argument("--search-threshold", type=int, default=4096,
                   help="library size above which responses use two-stage "
                        "top-k search instead of full score enumeration")
    s.add_argument("--top-k", type=int, default=5)
    s.add_argument("--sessions-dir", default="", metavar="DIR",
                   help="persist live-recognition sessions here on shutdown "
                        "and restore them on boot (same library required)")
    s.add_argument("--stream-pool", action="store_true",
                   help="pool live-recognition sessions in one slot-batched "
                        "matcher: concurrent posts fold into a single "
                        "device dispatch per flush window")
    s.add_argument("--stream-flush-window", type=float, default=0.02,
                   metavar="S", help="pooled-session flush window seconds")
    s.set_defaults(fn=cmd_serve)

    cl = sub.add_parser("client", help="POST a clip to a running server")
    cl.add_argument("clip")
    cl.add_argument("--url", default="http://127.0.0.1:8414")
    cl.add_argument("--fingerprint", action="store_true",
                    help="request /fingerprint instead of /identify")
    cl.add_argument("--local-extract", action="store_true",
                    help="fingerprint locally and upload only the "
                         "fingerprint string (the essay's phone-side "
                         "extraction protocol)")
    cl.add_argument("--timeout", type=float, default=120.0)
    cl.set_defaults(fn=cmd_client)

    li = sub.add_parser("listen", help="stream a clip's fingerprint to a "
                        "running server in increments (live recognition)")
    li.add_argument("clip")
    li.add_argument("--url", default="http://127.0.0.1:8414")
    li.add_argument("--chunk", type=int, default=4, metavar="K",
                    help="subfingerprints per post")
    li.add_argument("--timeout", type=float, default=120.0)
    li.set_defaults(fn=cmd_listen)
    return p


def main(argv: list[str] | None = None) -> int:
    from lbaudiodetective.utils.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
