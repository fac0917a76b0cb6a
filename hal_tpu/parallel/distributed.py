"""Multi-process (multi-host) distribution over jax.distributed.

The reference scales across machines by launching CLI subprocesses over a
shared filesystem and concatenating their text outputs
(stats/halStats.py:33-48 runParallelShellCommands, maf/hal2mafMP.py:176
runParallelSlices).  The replacement here: every process joins one
jax.distributed job, query batches are sharded over the global 'data' mesh
axis, reductions ride the collective fabric (NVLink within a host, the
network across hosts), and ordered outputs are merged with a sorted-stream merge instead
of file concatenation.

Entry points:
  * initialize(...)          — jax.distributed bootstrap for one process
  * global_mesh(...)         — mesh over ALL processes' devices
  * distributed_histogram(...) — the sharded liftover+depth step with a
    cross-process psum (the config #5 workload shape)
  * merge_sorted_blocks(...) — allgather + k-way merge of per-process
    coordinate-sorted block streams (replaces hal2mafMP's concatenation;
    every process returns the same globally sorted array)

Run `python -m hal_tpu.tools.benchScaling --processes N` or the
tests/test_multiprocess.py harness to exercise a multi-process job on one
machine (CPU backend, DCN = local gRPC); on a real pod slice the same code
path spans hosts.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_device_count: int | None = None) -> None:
    """jax.distributed.initialize for one process of a multi-process job.

    For CPU-backend jobs (tests, dev machines) set local_device_count to
    force that many virtual devices per process BEFORE backend init."""
    import os

    if local_device_count:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=%d"
                % local_device_count).strip()
    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "data"):
    """1-D mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_global_batch(mesh, arrays, axis: str = "data"):
    """Build global sharded arrays from per-process local chunks.

    Every process passes ITS chunk (the global batch is the concatenation
    in process order); returns global jax.Arrays sharded over `axis`."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(axis))
    out = []
    for a in arrays:
        out.append(jax.make_array_from_process_local_data(sh, np.asarray(a)))
    return tuple(out)


def distributed_coverage(path, caps, tgt_len: int, mesh, lo, hi, owner):
    """Cross-process sharded step: each device maps its interval shard
    through the genome path and scatter-adds an exact per-position target
    coverage (diff + cumsum); one psum over 'data' merges across every
    chip and host.  Returns the replicated coverage vector as numpy
    (identical on every process)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from hal_tpu.ops.segmap_jax import C_THI, C_TLO, C_VALID, _run_path

    def local_step(lo, hi, owner):
        F, _b, _ovf, _lt = _run_path(path, lo, hi, owner, caps)
        valid = (F[C_VALID] > 0).astype(jnp.int64)
        t0 = jnp.clip(F[C_TLO], 0, tgt_len).astype(jnp.int32)
        t1 = jnp.clip(F[C_THI], 0, tgt_len).astype(jnp.int32)
        d = jnp.zeros((tgt_len + 1,), jnp.int64)
        d = d.at[t0].add(valid).at[t1].add(-valid)
        return jax.lax.psum(jnp.cumsum(d)[:tgt_len], "data")

    step = jax.jit(jax.shard_map(
        local_step, mesh=mesh, in_specs=(P("data"), P("data"), P("data")),
        out_specs=P(), check_vma=False))
    # fully replicated output: every process holds the whole vector
    return np.asarray(step(lo, hi, owner))


def merge_sorted_blocks(local_blocks: np.ndarray) -> np.ndarray:
    """Globally merge per-process block streams sorted by their first
    column (e.g. reference-coordinate block starts).  allgather over DCN,
    then one k-way merge; every process gets the same sorted array.

    This is the collective replacement for hal2mafMP's 'rename the first
    slice file, append the rest' merge (maf/hal2mafMP.py:81-100): block
    streams stay in coordinate order end-to-end with no shared filesystem."""
    import jax
    from jax.experimental import multihost_utils

    local_blocks = np.ascontiguousarray(local_blocks)
    gathered = multihost_utils.process_allgather(local_blocks, tiled=False)
    chunks = [np.asarray(c) for c in gathered]
    merged = np.concatenate(chunks, axis=0)
    if merged.ndim == 1:
        order = np.argsort(merged, kind="stable")
    else:
        order = np.lexsort(tuple(merged[:, k] for k in
                                 range(merged.shape[1] - 1, -1, -1)))
    return merged[order]
