"""Sharded liftover/depth step over a device mesh.

The canonical multi-chip workload (BASELINE.json config #5): a batch of
query intervals is sharded over the 'data' mesh axis, each device maps its
shard through the genome path (the jit segment-map kernel), computes a
local coverage histogram over the target coordinate space, and the
histograms are reduced across 'data' and sharded over 'coord'
(reduce_scatter semantics) — the collective replacing hal2mafMP.py's
"concatenate partial files on a shared filesystem".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hal_tpu.ops.segmap_jax import (PathData, _run_path,
                                    C_TLO, C_THI, C_VALID)


def ensure_virtual_devices(n: int) -> None:
    """Make n devices available.  The CPU platform gets n virtual devices
    (XLA's host device count, re-initialising the backend if it already
    started with fewer); any other platform must have n devices already,
    else this raises.  Must run before heavy device use."""
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=%d" % n).strip()
    if jax.device_count() < n and jax.default_backend() == "cpu":
        from jax.extend import backend as _jexb

        _jexb.clear_backends()
    if jax.device_count() < n:
        raise RuntimeError("need %d devices, have %d %s devices"
                           % (n, jax.device_count(), jax.default_backend()))


def make_mesh(n_data: int, n_coord: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_data * n_coord, "not enough devices"
    dev = np.asarray(devices[: n_data * n_coord]).reshape(n_data, n_coord)
    return Mesh(dev, ("data", "coord"))


def make_sharded_step(path: PathData, caps: tuple, tgt_len: int, n_bins: int, mesh: Mesh):
    """Returns a jitted SPMD step: (lo, hi, owner) sharded over 'data' ->
    (fragment arrays sharded over 'data', depth histogram sharded over 'coord')."""

    n_coord = mesh.shape["coord"]
    assert n_bins % n_coord == 0

    def local_step(lo, hi, owner):
        F, _bound, _ovf, _lt = _run_path(path, lo, hi, owner, caps)
        t_lo = F[C_TLO]
        t_hi = F[C_THI]
        valid = F[C_VALID] > 0
        # local coverage histogram over target bins (alignment-depth shape;
        # exact per-base depth uses diff+cumsum in ops/depth)
        bin_of = jnp.clip(t_lo * n_bins // max(tgt_len, 1), 0, n_bins - 1)
        cov = jnp.zeros((n_bins,), jnp.int64)
        cov = cov.at[bin_of].add(jnp.where(valid, t_hi - t_lo, 0))
        # merge across data shards, scatter across coord shards (collective)
        cov = jax.lax.psum(cov, "data")
        k = n_bins // n_coord
        ci = jax.lax.axis_index("coord")
        cov_shard = jax.lax.dynamic_slice(cov, (ci * k,), (k,))
        return F, cov_shard

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P(None, "data"), P("coord")),
        check_vma=False,
    )
    return jax.jit(step)


# ---------------------------------------------------------------------------
# table-sharded traversal: the genome segment arrays themselves are
# distributed across the mesh (north-star "segment arrays sharded
# per-genome/per-chromosome"; reference per-genome storage decomposition
# api/hdf5_impl/hdf5Genome.cpp:29-33).  Each Level's tables REST sharded
# 1/D per device along the segment axis and are all-gathered only for the
# one hop that needs them, then freed (the FSDP pattern applied to lookup
# tables instead of weights) — so alignments larger than a single device's
# memory still traverse at device speed.
# ---------------------------------------------------------------------------

def _pad_last(a: np.ndarray, mult: int, edge: bool):
    """Pad the last axis to a multiple of `mult` — repeating the edge value
    (sorted grids keep their searchsorted semantics: pad entries equal the
    end sentinel, which no in-range query ever reaches) or with zeros
    (gather-indexed tables: pad columns are only touched by masked-out
    slots)."""
    n = a.shape[-1]
    pad = (-n) % mult
    if pad == 0:
        return a
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return np.pad(a, widths, mode="edge" if edge else "constant")


def shard_path_tables(path: PathData, mesh: Mesh, axis: str = "data") -> PathData:
    """Return a PathData whose per-level arrays are device_put sharded
    along `axis` on their segment dimension (1-D arrays on axis 0, packed
    (fields, n) tables on axis 1).  No device holds more than ~1/D of the
    total segment tables at rest."""
    import jax

    from hal_tpu.ops.segmap_jax import Level

    d = mesh.shape[axis]
    sh1 = NamedSharding(mesh, P(axis))
    sh2 = NamedSharding(mesh, P(None, axis))

    def put(level: Level) -> Level:
        grid = jax.device_put(_pad_last(np.asarray(level.grid), d, True), sh1)
        seg = jax.device_put(_pad_last(np.asarray(level.seg_table), d, False), sh2)
        ring = jax.device_put(_pad_last(np.asarray(level.ring_mem_tab), d, False), sh2)
        page = (None if level.page_tab is None else jax.device_put(
            _pad_last(np.asarray(level.page_tab), d, True), sh1))
        return Level(kind=level.kind, grid=grid, seg_table=seg,
                     ring_mem_tab=ring, max_ring=level.max_ring,
                     page_tab=page, page_shift=level.page_shift)

    return PathData(
        levels=tuple(put(lv) for lv in path.levels), n_up=path.n_up,
        para=tuple((put(up), tuple(put(dv) for dv in downs))
                   for (up, downs) in path.para),
        min_length=path.min_length)


def make_table_sharded_step(path_sh: PathData, caps: tuple, mesh: Mesh,
                            axis: str = "data"):
    """Jitted SPMD step over table-sharded PathData: queries shard over
    `axis`; each level's tables are lax.all_gather'd (tiled) right before
    its split/hop and dropped after (segmap_jax._run_path level_xform hook).

    Returns step(lo, hi, owner) -> (F local fragments (devices stacked on
    the capacity axis), per-device overflow flags)."""
    from hal_tpu.ops.segmap_jax import Level, _run_path

    def gather_level(lv: Level) -> Level:
        def ag1(x):
            return jax.lax.all_gather(x, axis, tiled=True)

        def ag2(x):
            return jax.lax.all_gather(x, axis, axis=1, tiled=True)

        return Level(kind=lv.kind, grid=ag1(lv.grid),
                     seg_table=ag2(lv.seg_table),
                     ring_mem_tab=ag2(lv.ring_mem_tab), max_ring=lv.max_ring,
                     page_tab=None if lv.page_tab is None else ag1(lv.page_tab),
                     page_shift=lv.page_shift)

    def local_step(lo, hi, owner, path_local):
        F, _bound, ovf, _lt = _run_path(path_local, lo, hi, owner, caps,
                                        level_xform=gather_level)
        return F, ovf.reshape(1)

    flat, treedef = jax.tree_util.tree_flatten(path_sh)
    table_specs = jax.tree_util.tree_unflatten(
        treedef, [P(axis) if x.ndim == 1 else P(None, axis) for x in flat])

    step = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), table_specs),
        out_specs=(P(None, axis), P(axis)),
        check_vma=False,
    )
    jstep = jax.jit(step)
    return lambda lo, hi, owner: jstep(lo, hi, owner, path_sh)


def shard_batch(mesh: Mesh, lo: np.ndarray, hi: np.ndarray, owner: np.ndarray):
    """Pad a host batch to a multiple of the data-axis size and device_put
    with a 'data' sharding."""
    n_data = mesh.shape["data"]
    n = len(lo)
    pad = (-n) % n_data
    if pad:
        lo = np.concatenate([lo, np.zeros(pad, lo.dtype)])
        hi = np.concatenate([hi, np.zeros(pad, hi.dtype)])  # hi==lo -> invalid
        owner = np.concatenate([owner, np.full(pad, -1, owner.dtype)])
    sh = NamedSharding(mesh, P("data"))
    return (jax.device_put(lo, sh), jax.device_put(hi, sh), jax.device_put(owner, sh))
