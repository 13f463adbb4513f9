"""Worker for the REAL 2-process jax.distributed test (see
tests/test_distributed.py::test_two_process_library_sharded_match).

Each process: joins the cluster through parallel.distributed.initialize,
mmap-loads ITS OWN library shards from the sharded checkpoint, assembles the
globally-sharded library array, runs the library-sharded matcher over the
cross-process mesh (gloo CPU collectives), and writes its addressable score
shards for the driver to assemble and verify.

Usage: _dist_worker.py <port> <pid> <nprocs> <libdir> <query.npz> <out.npz>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import numpy as np


def main():
    port, pid, nprocs, libdir, query_npz, out_npz = sys.argv[1:7]
    pid, nprocs = int(pid), int(nprocs)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from lbaudiodetective.parallel import distributed

    distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nprocs, process_id=pid)
    n_dev = len(jax.devices())
    assert n_dev == 2 * nprocs, f"expected {2 * nprocs} global devices, got {n_dev}"

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.parallel.sharded import match_library_sharded
    from lbaudiodetective.utils import packing
    from lbaudiodetective.utils.serialize import load_library_shard

    cfg = FingerprintConfig()
    # Shard s of the checkpoint lives on global device s; this process's
    # devices hold shards [2*pid, 2*pid+2) — the shard-local reload story.
    shards = []
    man = None
    for s in range(2 * pid, 2 * pid + 2):
        pos_w, neg_w, counts, man = load_library_shard(libdir, s, cfg)
        pos = packing.unpack_bits(np.asarray(pos_w).reshape(-1, man["words"]),
                                  man["pairs"]).reshape(
            man["entries_per_shard"], man["s_max"], man["pairs"])
        neg = packing.unpack_bits(np.asarray(neg_w).reshape(-1, man["words"]),
                                  man["pairs"]).reshape(
            man["entries_per_shard"], man["s_max"], man["pairs"])
        shards.append((pos.astype(np.uint8), neg.astype(np.uint8),
                       np.asarray(counts)))

    local_pos = np.concatenate([s[0] for s in shards])
    local_neg = np.concatenate([s[1] for s in shards])
    local_cnt = np.concatenate([s[2] for s in shards])

    mesh = Mesh(np.array(jax.devices()).reshape(1, n_dev), ("data", "library"))
    lib_sh = NamedSharding(mesh, P("library", None, None))
    cnt_sh = NamedSharding(mesh, P("library"))
    lib_pos = jax.make_array_from_process_local_data(lib_sh, local_pos)
    lib_neg = jax.make_array_from_process_local_data(lib_sh, local_neg)
    lib_cnt = jax.make_array_from_process_local_data(cnt_sh, local_cnt)

    q = np.load(query_npz)
    scores = match_library_sharded(
        jnp.asarray(q["pos"]), jnp.asarray(q["neg"]), jnp.int32(q["n"]),
        lib_pos, lib_neg, lib_cnt, mesh, 0, cfg.subfingerprint_length)
    jax.block_until_ready(scores)

    idx, vals = [], []
    for sh in scores.addressable_shards:
        lo = sh.index[0].start or 0
        arr = np.asarray(sh.data)
        idx.extend(range(lo, lo + arr.shape[0]))
        vals.extend(arr.tolist())

    # Ring all-pairs across the PROCESS boundary: query blocks rotate around
    # the 4-device mesh via lax.ppermute (two of the hops cross processes
    # over gloo).  Every valid entry must self-match at ~1 on the diagonal.
    from lbaudiodetective.parallel.sharded import ring_all_pairs_scores

    ring = ring_all_pairs_scores(lib_pos, lib_neg, lib_cnt, mesh)
    jax.block_until_ready(ring)
    row0 = 2 * pid * man["entries_per_shard"]    # this process's first row
    diag_checked = 0
    for sh in ring.addressable_shards:
        lo = sh.index[0].start or 0
        arr = np.asarray(sh.data)                # [rows, L] global columns
        for i in range(arr.shape[0]):
            g = lo + i
            if local_cnt[g - row0] > 0:
                assert abs(float(arr[i, g]) - 1.0) < 1e-5, \
                    f"ring self-match {float(arr[i, g])} at {g}"
                diag_checked += 1
    assert diag_checked > 0, "no valid diagonal entries checked"
    np.savez(out_npz, idx=np.asarray(idx), scores=np.asarray(vals))
    print(f"pid{pid} OK {len(vals)} scores, ring diag x{diag_checked}", flush=True)


if __name__ == "__main__":
    main()
