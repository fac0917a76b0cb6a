"""Shard-local table traversal: the memory-scaling variant of the
table-sharded SPMD step.

parallel.sharded.make_table_sharded_step keeps segment tables resting 1/D
per device but all-gathers ONE level's full table before its hop — peak
per-device HBM is (tables)/D + max_level_table.  This module removes that
last rematerialization: tables stay sharded through the hop, and the
QUERY FRAGMENTS move instead.  Per level:

  1. split local fragments at the level's D-1 shard-boundary coordinates
     (a tiny replicated array), so every piece falls in exactly one
     device's segment range,
  2. route each piece to its owning device with ONE lax.all_to_all
     (bucketed fixed-capacity send buffers, overflow-flagged),
  3. hop against the LOCAL (fields, m/D) table slab — paralogy-ring
     expansion included (the ring member CSR table is replicated: it is
     O(paralogous segments), a small minority next to the segment tables;
     ring members may land in any shard and the NEXT level's split+route
     re-buckets them).

Peak per-device memory is (tables)/D + fragment buffers: alignments larger
than one device's memory traverse without ever materializing a full level.
The trade is one fragment-sized all-to-all per level instead of one
table-sized all-gather — the right side of the ledger whenever tables >>
in-flight fragments, which is exactly the mammal-alignment regime (11M
segments vs ~1M fragments in the bench).

North star: "segment arrays sharded per-genome/per-chromosome across
chips".  Correctness is oracle-tested on the
virtual 8-device mesh (tests/test_ring_sharded.py); capacities are caller
-chosen with overflow flags (generous-caps + retry semantics, unlike the
replicated path's exact host sizing).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hal_tpu.ops.segmap_jax import (PathData, _expand_owner,
                                    _rows)


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[-1] >= n:
        return a[..., :n]
    pad = n - a.shape[-1]
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return np.pad(a, widths, constant_values=fill)


class RingLevel:
    """Host-built per-shard slabs for one traversal level."""

    def __init__(self, level, D: int):
        grid = np.asarray(level.grid, np.int64)          # m+1
        seg = np.asarray(level.seg_table, np.int64)      # (8, m)
        ring = np.asarray(level.ring_mem_tab, np.int64)  # (4, nnz)
        m = seg.shape[1]
        s = (m + D - 1) // D
        end = int(grid[-1]) if len(grid) else 0
        gridp = _pad_to(grid, D * s + 1, end)
        segp = _pad_to(seg, D * s, 0)  # has_link=0 on pad columns
        g_sh = np.stack([gridp[k * s:(k + 1) * s + 1] for k in range(D)])
        t_sh = np.stack([segp[:, k * s:(k + 1) * s] for k in range(D)])
        self.bounds = gridp[np.arange(1, D) * s].copy()  # (D-1,) replicated
        self.kind = level.kind
        self.max_ring = level.max_ring
        self.s = s
        self.grid_sh = g_sh
        self.seg_sh = t_sh
        # the ring member CSR table is REPLICATED: its offsets are indexed
        # through the (shuffled) child links, so contiguous per-shard
        # slabs do not exist; it is O(paralogous segments) — a small
        # minority next to the segment tables it accompanies
        self.ring_tab = ring if ring.shape[1] else np.zeros((4, 1), np.int64)


def build_ring_path(path: PathData, D: int):
    """Host prep: RingLevel per main-chain level (build the PathData with
    the default coalescence limit; paralogy branches above the MRCA are
    served by the replicated/table-gather paths)."""
    assert not path.para, "ring-sharded traversal serves main-chain paths"
    return [RingLevel(lv, D) for lv in path.levels]


def make_ring_sharded_step(ring_levels, caps, mesh: Mesh, axis: str = "data"):
    """Jitted SPMD step over shard-local tables.

    caps: per level (cap_split, cap_send, cap_hop, cap_ring) — static
    capacities for the boundary split, the per-destination all_to_all
    buckets, the local segment-split expansion, and the ring expansion
    (0 when the level has no rings).  Returns step(lo, hi, owner) ->
    (F (8, D*cols) fragments stacked over the mesh, per-device overflow
    flags)."""
    D = mesh.shape[axis]

    sh2 = NamedSharding(mesh, P(axis, None))
    sh3 = NamedSharding(mesh, P(axis, None, None))
    static = [(rl.kind, rl.max_ring, rl.s) for rl in ring_levels]
    arrays = [dict(grid=jax.device_put(jnp.asarray(rl.grid_sh), sh2),
                   seg=jax.device_put(jnp.asarray(rl.seg_sh), sh3),
                   ring=jnp.asarray(rl.ring_tab),
                   bounds=jnp.asarray(rl.bounds))
              for rl in ring_levels]
    arr_specs = [dict(grid=P(axis, None), seg=P(axis, None, None),
                      ring=P(None, None), bounds=P(None))
                 for _ in ring_levels]

    def split_at(values, F, cap_out):
        """Split fragment targets at a small sorted coordinate set so each
        piece lies within one shard's range."""
        dt = F.dtype
        nv = values.shape[0]
        valid = F[6] > 0
        i0 = jnp.searchsorted(values, F[2], side="right").astype(dt)
        i1 = jnp.searchsorted(values, F[3], side="left").astype(dt)
        counts = jnp.where(valid, i1 - i0 + 1, 0)
        own, offs, total = _expand_owner(counts, cap_out)
        # pack ONLY the rows the expansion reads (s_hi is re-derived and
        # validity re-computed): 8 rows keeps the gather temp inside the
        # T(8,128) sublane tile (CLAUDE.md packing rule)
        G = jnp.stack([F[0], F[2], F[3], F[4], F[5], offs.astype(dt), i0,
                       counts.astype(dt)], axis=0)
        R = _rows(jnp.take(G, own, axis=1))
        r_slo, r_tlo, r_thi, r_rev, r_own, r_offs, r_i0, r_cnt = R
        j = jnp.arange(cap_out, dtype=dt)
        k = j - r_offs
        first = k == 0
        last = k == r_cnt - 1
        ci = r_i0 + k
        lo = jnp.where(first, r_tlo,
                       jnp.take(values, jnp.clip(ci - 1, 0, nv - 1)))
        hi = jnp.where(last, r_thi,
                       jnp.take(values, jnp.clip(ci, 0, nv - 1)))
        v = (j < total.astype(dt)) & (hi > lo)
        adv = jnp.where(r_rev > 0, r_thi - hi, lo - r_tlo)
        s_lo = r_slo + adv
        Fout = jnp.stack([s_lo, s_lo + (hi - lo), lo, hi, r_rev, r_own,
                          v.astype(dt), jnp.zeros_like(s_lo)], axis=0)
        return Fout, total > cap_out

    def route(F, bounds, cap_send):
        """Bucket fragments by destination shard; one all_to_all."""
        dt = F.dtype
        valid = F[6] > 0
        dest = jnp.searchsorted(bounds, F[2], side="right").astype(jnp.int32)
        dest = jnp.where(valid, dest, D)
        order = jax.lax.sort(
            (dest, jnp.arange(F.shape[1], dtype=jnp.int32)), num_keys=1,
            is_stable=True)
        dest_s, col_s = order
        rank = jnp.arange(F.shape[1], dtype=jnp.int32) - jnp.searchsorted(
            dest_s, dest_s, side="left").astype(jnp.int32)
        slot = jnp.where((dest_s < D) & (rank < cap_send),
                         dest_s * cap_send + rank, D * cap_send)
        Fs = jnp.take(F, col_s, axis=1)
        buf = jnp.zeros((8, D * cap_send), dt).at[:, slot].set(Fs,
                                                               mode="drop")
        ovf = jnp.any((dest_s < D) & (rank >= cap_send))
        send = jnp.moveaxis(buf.reshape(8, D, cap_send), 0, 2)
        recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0)
        Fr = jnp.moveaxis(recv, 2, 0).reshape(8, D * cap_send)
        return Fr, ovf

    def local_hop(kind, max_ring, s, arrs, F, cap_hop, cap_ring):
        """Segment split + link hop against the LOCAL table slab."""
        dt = F.dtype
        grid = arrs["grid"].reshape(-1)   # (s+1,)
        seg = arrs["seg"].reshape(8, -1)  # (8, s)
        valid = F[6] > 0
        i0 = (jnp.searchsorted(grid, F[2], side="right") - 1).astype(dt)
        i1 = (jnp.searchsorted(grid, F[3] - 1, side="right") - 1).astype(dt)
        i0 = jnp.clip(i0, 0, s - 1)
        i1 = jnp.clip(i1, 0, s - 1)
        counts = jnp.where(valid & (i1 >= i0), i1 - i0 + 1, 0)
        own, offs, total = _expand_owner(counts, cap_hop)
        G = jnp.concatenate([F[:6], offs[None, :].astype(dt),
                             i0[None, :]], axis=0)
        R = _rows(jnp.take(G, own, axis=1))
        j = jnp.arange(cap_hop, dtype=dt)
        k = j - R[6]
        segi = jnp.clip(R[7] + k, 0, s - 1)
        ST = _rows(jnp.take(seg, segi, axis=1))
        p_lo = jnp.maximum(R[2], ST[0])
        p_hi = jnp.minimum(R[3], ST[1])
        rev = R[4]
        adv = jnp.where(rev > 0, R[3] - p_hi, p_lo - R[2])
        s_lo = R[0] + adv
        ln = p_hi - p_lo
        v = (j < total.astype(dt)) & (p_hi > p_lo)
        has = v & (ST[4] > 0)
        ds = ST[2]
        off = p_lo - ST[0]
        mirrored = ST[1] - p_hi
        new_lo = jnp.where(ST[3] > 0, ds + mirrored, ds + off)
        Fout = jnp.stack([s_lo, s_lo + ln, new_lo, new_lo + ln, rev ^ ST[3],
                          R[5], has.astype(dt), ds], axis=0)
        ovf = total > cap_hop
        if kind == "down" and max_ring > 0:
            ringtab = arrs["ring"]  # replicated (4, nnz)
            rc = jnp.where(has, ST[5], 0)
            ro = ST[6]
            own2, offs2, tot2 = _expand_owner(rc, cap_ring)
            off_row = Fout[2] - Fout[7]
            ln_row = Fout[3] - Fout[2]
            G2 = jnp.concatenate([Fout[:2], off_row[None, :],
                                  ln_row[None, :], Fout[4:6],
                                  offs2[None, :].astype(dt),
                                  ro[None, :]], axis=0)
            R2 = _rows(jnp.take(G2, own2, axis=1))
            j2 = jnp.arange(cap_ring, dtype=dt)
            k2 = j2 - R2[6]
            nnz = ringtab.shape[1]
            midx = jnp.clip(R2[7] + k2, 0, nnz - 1)
            MT = _rows(jnp.take(ringtab, midx, axis=1))
            offm = R2[2]
            ln2 = R2[3]
            nlo = jnp.where(MT[2] > 0, MT[1] - offm - ln2, MT[0] + offm)
            v2 = j2 < tot2.astype(dt)
            F2 = jnp.stack([R2[0], R2[1], nlo, nlo + ln2, R2[4] ^ MT[2],
                            R2[5], v2.astype(dt), jnp.zeros_like(nlo)],
                           axis=0)
            Fout = jnp.concatenate([Fout, F2], axis=1)
            ovf |= tot2 > cap_ring
        return Fout, ovf

    def wrapped(lo, hi, owner, arrays_in):
        dt = lo.dtype
        n = lo.shape[0]
        z = jnp.zeros(n, dt)
        F = jnp.stack([lo, hi, lo, hi, z, owner, (hi > lo).astype(dt), z],
                      axis=0)
        overflow = jnp.asarray(False)
        for (kind, max_ring, s), arrs, cap in zip(static, arrays_in, caps):
            cap_split, cap_send, cap_hop, cap_ring = cap
            if D > 1:
                Fs, ov1 = split_at(arrs["bounds"], F, cap_split)
                Fr, ov2 = route(Fs, arrs["bounds"], cap_send)
                overflow |= ov1 | ov2
            else:
                Fr = F
            F, ov3 = local_hop(kind, max_ring, s, arrs, Fr, cap_hop,
                               cap_ring)
            overflow |= ov3
        return F, overflow.reshape(1)

    step = jax.shard_map(
        wrapped, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), arr_specs),
        out_specs=(P(None, axis), P(axis)),
        check_vma=False,
    )
    jstep = jax.jit(step)
    return lambda lo, hi, owner: jstep(lo, hi, owner, arrays)
