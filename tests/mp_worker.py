"""Worker process for test_multiprocess: joins a 2-process jax.distributed
job on the CPU backend (DCN stand-in), runs the sharded liftover+histogram
step and the sorted-block merge, and writes its results for the test to
assert against the single-process oracle.

Usage: python tests/mp_worker.py <process_id> <num_processes> <port> <outdir>
"""

import os
import sys


def main():
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (flags +
                               " --xla_force_host_platform_device_count=2").strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax

    from hal_tpu.parallel import distributed as dist

    dist.initialize("localhost:" + port, nproc, pid)

    import numpy as np

    assert jax.process_count() == nproc
    assert jax.device_count() == 2 * nproc

    from hal_tpu.randgen import create_random_alignment
    from hal_tpu.ops import segmap_jax as sj

    aln = create_random_alignment(seed=17, max_genomes=5, min_genomes=4,
                                  min_segments=6, max_segments=30,
                                  min_segment_length=4, max_segment_length=12)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    g = aln.open_genome(src)
    tg = aln.open_genome(tgt)

    rng = np.random.default_rng(3)
    n = 64  # global batch
    lo = rng.integers(0, g.length - 2, n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 20, n), g.length)
    owner = np.arange(n, dtype=np.int64)

    path = sj.PathData.build(aln, src, tgt, dtype=None)
    dtype = np.int32 if path.levels[0].grid.dtype == np.int32 else np.int64
    lo, hi, owner = lo.astype(dtype), hi.astype(dtype), owner.astype(dtype)
    totals = sj.host_level_totals(aln, src, tgt, lo, hi)
    caps = sj.tight_caps(path, totals, slack=2.0)

    mesh = dist.global_mesh()
    chunk = n // nproc
    s = pid * chunk
    glo, ghi, gown = dist.shard_global_batch(
        mesh, (lo[s:s + chunk], hi[s:s + chunk], owner[s:s + chunk]))

    hist = dist.distributed_coverage(path, caps, tg.length, mesh,
                                     glo, ghi, gown)

    # sorted-block merge: each process contributes its own sorted chunk
    local_sorted = np.sort(lo[s:s + chunk])
    merged = dist.merge_sorted_blocks(local_sorted)

    np.savez(os.path.join(outdir, "proc%d.npz" % pid),
             hist=hist, merged=merged)
    print("proc %d ok" % pid)


if __name__ == "__main__":
    main()
