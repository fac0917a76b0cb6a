"""Batched segment mapper on device (JAX) — the liftover kernel.

Same fragment algebra as hal_tpu.ops.segmap_host (the correctness oracle)
but jit-compiled with static capacities so the whole genome-path traversal
is one fused XLA program of gathers + scans:

  * the tree path (src -> mrca -> tgt) is precomputed on host and baked
    into the trace as an unrolled loop over levels (PathData),
  * raggedness (a fragment splitting at segment boundaries, paralogy rings)
    is handled with bounded-capacity expansion + mask compaction — the
    standard segmented-scan/expansion pattern, no data-dependent shapes
    anywhere,
  * an overflow flag is returned; the host wrapper doubles capacity and
    retries (compile cache per capacity).

Layout:
  * fragment state lives in ONE packed (8, cap) matrix — fields on the
    first axis, fragments on the second — gathered a column at a time
    (jnp.take axis=1).  On an H100 the transposes XLA inserts around
    those column gathers are about half of a batch's device time (PERF.md);
    a row-major (cap, 8) layout is the open alternative,
  * per-level segment metadata is packed the same way, with all
    link-dependent values pre-joined on host into one (8, m) seg_table —
    one column gather per hop instead of five,
  * the expansion owner index (which input owns output slot j) is computed
    with scatter-max + cummax over the slot range, no sort,
  * the segment lookup is the paged binary search (_build_page_table),
    the fastest lookup on the card at every width measured (PERF.md);
    jnp.searchsorted serves only grids whose page table cannot be built.

Fragments carry an `owner` id so one kernel call lifts an entire batch of
BED intervals while preserving per-interval semantics downstream.

Reference equivalents: api/impl/halSegmentMapper.cpp (mapUp :25, mapDown
:128, mapSelf :263, mapRecursive* :85/:191/:525).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# genome coordinates exceed int32 (human ~3.1e9); index math must be 64-bit
jax.config.update("jax_enable_x64", True)

from hal_tpu.constants import NULL_INDEX
from hal_tpu.alignment import Alignment

TOP = 0
BOTTOM = 1

# packed fragment-state rows of the (8, cap) state matrix
C_SLO, C_SHI, C_TLO, C_THI, C_REV, C_OWN, C_VALID, C_AUX = range(8)

# paged lookup: window of candidate segments per query after the page-table
# hop; pages are sized on host so a page never spans more segments
_PAGE_WINDOW = 64


def _build_page_table(starts: np.ndarray):
    """Host precompute of the segment lookup: page_first[k] = index of the
    segment containing coordinate k << shift.  The page shift is chosen so
    no page overlaps more than _PAGE_WINDOW-1 segment starts, bounding the
    device-side binary search to log2(_PAGE_WINDOW) clipped gathers — on
    an H100 this beats every jnp.searchsorted method (1.1M segments:
    0.21 ms against 0.31 ms for the best of them over 2^20 queries;
    PERF.md has the smaller grids).

    Returns (page_first int32 array, shift) or (None, 0) when unbuildable."""
    n_seg = len(starts) - 1
    total = int(starts[-1]) if len(starts) else 0
    if n_seg <= 1 or total <= 1:
        return None, 0
    starts = np.asarray(starts, np.int64)
    shift = max(int(total - 1).bit_length(), 1)
    while True:
        bounds = np.arange(0, total + (1 << shift), 1 << shift, dtype=np.int64)
        firsts = np.searchsorted(starts, bounds[:-1], side="right") - 1
        lasts = np.searchsorted(
            starts, np.minimum(bounds[1:], total) - 1, side="right") - 1
        span = int((lasts - firsts).max()) + 1 if len(firsts) else 1
        if span <= _PAGE_WINDOW - 1:
            return np.maximum(firsts, 0).astype(np.int32), shift
        if shift == 1 or len(bounds) > 4 * n_seg + 16:
            return None, 0  # pathological clustering: caller falls back
        shift -= 1


def _searchsorted_right(grid, q, page_tab=None, page_shift=0):
    """jnp.searchsorted(grid, q, side="right") in q's dtype: the paged
    lookup when the level has a page table, else XLA's unrolled binary
    search."""
    if page_tab is None:
        return jnp.searchsorted(grid, q, side="right",
                                method="scan_unrolled").astype(q.dtype)
    # paged: page-table hop + unrolled binary search over the page window
    n = grid.shape[0]
    dt = q.dtype
    page = jnp.clip((q >> page_shift).astype(jnp.int32), 0, page_tab.shape[0] - 1)
    i = jnp.take(page_tab, page).astype(dt)
    step = _PAGE_WINDOW >> 1
    while step:
        j = jnp.minimum(i + step, n - 1)
        i = jnp.where(jnp.take(grid, j) <= q, j, i)
        step >>= 1
    return jnp.where(q < grid[0], 0, i + 1).astype(dt)


@dataclass(frozen=True)
class Level:
    """One traversal level's device arrays (packed (fields, n) tables).

    All link-dependent values (destination start, ring CSR row) are
    PRE-JOINED into seg_table on host — they are pure functions of the
    segment index, so the device needs ONE column gather per hop instead
    of a second indirection through a dst table."""

    kind: str  # 'up' | 'down'
    # sorted split grid: segment starts incl. end sentinel (n_seg+1)
    grid: jnp.ndarray
    # (8, n_seg) rows: [start, next_start, dst_start, link_reversed,
    #                   has_link, ring_count, ring_offset, 0]
    seg_table: jnp.ndarray
    # (4, nnz) rows: [member_start, member_next_start, flip, 0] (down+dupes)
    ring_mem_tab: jnp.ndarray
    max_ring: int
    # segment lookup: page_first table + shift (None when unbuildable)
    page_tab: jnp.ndarray | None = None
    page_shift: int = 0


@dataclass(frozen=True)
class PathData:
    levels: tuple
    n_up: int
    # paralogy branches above the MRCA (--coalescenceLimit, reference
    # mapRecursiveParalogies halSegmentMapper.cpp:525-576): branch k =
    # (up Level to height k, down Levels back to the MRCA with rings);
    # branch outputs are unioned with the MRCA fragments before the main
    # down phase
    para: tuple = ()
    min_length: int = 0

    @classmethod
    def build(cls, aln: Alignment, src: str, tgt: str, do_dupes: bool = True,
              dtype=None, coalescence_limit: str | None = None,
              min_length: int = 0) -> "PathData":
        """dtype: coordinate dtype for device arrays; defaults to int32 when
        every genome on the path fits, uint32 up to 4.29 Gb (covers every
        vertebrate chromosome-scale assembly; 32-bit rows halve the bytes
        every gather and transpose moves), else int64."""
        tree = aln.tree
        mrca = tree.lca(src, tgt)
        limit = coalescence_limit or mrca
        # limit must be an ancestor of (or equal to) the mrca
        anc = mrca
        chain = [mrca]
        while anc != limit:
            anc = tree.parent(anc)
            if anc is None:
                raise ValueError("coalescence limit %s is not an ancestor of "
                                 "the MRCA %s" % (limit, mrca))
            chain.append(anc)
        nodes = set(tree.path(src, tgt)) | set(chain)
        if dtype is None:
            max_len = max(aln.open_genome(n).length for n in nodes)
            max_seg = max(max(aln.open_genome(n).num_top_segments,
                              aln.open_genome(n).num_bottom_segments)
                          for n in nodes)
            mx = max(max_len, max_seg)
            dtype = (jnp.int32 if mx < 2 ** 31 - 2 else
                     jnp.uint32 if mx < 2 ** 32 - 2 else jnp.int64)
        def up_level(cur: str) -> Level:
            return build_up_level(aln, cur, dtype)

        def down_level(cur: str, nxt: str, rings: bool) -> Level:
            return build_down_level(aln, cur, nxt, rings, dtype)

        levels = []
        cur = src
        while cur != mrca:
            levels.append(up_level(cur))
            cur = tree.parent(cur)
        n_up = len(levels)
        if cur != tgt:
            for nxt in tree.path(cur, tgt)[1:]:
                levels.append(down_level(cur, nxt, do_dupes))
                cur = nxt

        para = []
        if do_dupes and limit != mrca:
            # branch k: hop up k levels above the MRCA, come back down with
            # ring expansion at every hop — captures every paralog class
            # coalescing at height <= k (union over k = host
            # _map_paralogies; fragments whose up-chain ends early are
            # preserved by the shallower branches)
            for k in range(1, len(chain)):
                up = up_level(chain[k - 1])
                downs = tuple(down_level(chain[j + 1], chain[j], True)
                              for j in range(k - 1, -1, -1))
                para.append((up, downs))
        return cls(levels=tuple(levels), n_up=n_up, para=tuple(para),
                   min_length=int(min_length))


def _np_dtype_of(dtype):
    return {jnp.dtype(jnp.int32): np.int32,
            jnp.dtype(jnp.uint32): np.uint32}.get(jnp.dtype(dtype), np.int64)


def _pack4(np_dtype, *cols):
    n = len(cols[0])
    m = np.zeros((max(len(cols), 4), max(n, 1)), np_dtype)
    for k, c in enumerate(cols):
        if n:
            m[k, :] = c
    return jnp.asarray(m)


def _seg_tab(np_dtype, starts, link, lrev, dst_start, rc, ro):
    """Pre-join the link hop (host): [start, next, dst_start, lrev,
    has_link, ring_count, ring_offset, 0] — link-dependent values are pure
    functions of the segment index, so the device does ONE column gather
    per hop instead of a second indirection."""
    n_seg = len(link)
    link = np.asarray(link, np.int64)
    lc = np.clip(link, 0, max(len(dst_start) - 1, 0))
    has = (link != NULL_INDEX).astype(np.int64)
    ds = (dst_start[lc] if len(dst_start) else np.zeros(n_seg, np.int64)) * has
    rcj = (rc[lc] if len(rc) else np.zeros(n_seg, np.int64)) * has
    roj = (ro[lc] if len(ro) else np.zeros(n_seg, np.int64)) * has
    z = np.zeros(n_seg, np.int64)
    return _pack4(np_dtype, starts[:n_seg], starts[1:n_seg + 1], ds,
                  np.asarray(lrev, np.int64), has, rcj, roj, z)


def _pages(starts):
    pt, ps = _build_page_table(starts)
    return (None if pt is None else jnp.asarray(pt)), ps


def build_up_level(aln: Alignment, cur: str, dtype,
                   canonical_only: bool = False) -> Level:
    """canonical_only: only segments whose parent's child link points back
    hop up (the noDupes gate — Hdf5TopSegment::isCanonicalParalog,
    reference hdf5TopSegment.cpp:55-66; ColumnDFS._update_parent's
    no_dupes check)."""
    g = aln.open_genome(cur)
    parent = aln.tree.parent(cur)
    pg = aln.open_genome(parent)
    n_seg = g.num_top_segments
    np_dtype = _np_dtype_of(dtype)
    z0 = np.zeros(0, np.int64)
    pt, ps = _pages(g.top_start)
    link = np.asarray(g.top_parent[:n_seg], np.int64).copy()
    if canonical_only and n_seg:
        slot = aln.tree.child_index(parent, cur)
        pi = np.clip(link, 0, max(pg.num_bottom_segments - 1, 0))
        back = (pg.bot_child[pi, slot] if pg.num_bottom_segments
                else np.full(n_seg, NULL_INDEX))
        canon = (link != NULL_INDEX) & (back == np.arange(n_seg))
        link = np.where(canon, link, NULL_INDEX)
    return Level(
        kind="up",
        grid=jnp.asarray(np.ascontiguousarray(g.top_start), dtype),
        seg_table=_seg_tab(np_dtype, g.top_start, link,
                           g.top_parent_reversed[:n_seg],
                           pg.bot_start[:pg.num_bottom_segments], z0, z0),
        ring_mem_tab=_pack4(np_dtype, np.zeros(0, np.int64)),
        max_ring=0,
        page_tab=pt, page_shift=ps,
    )


def build_down_level(aln: Alignment, cur: str, nxt: str, rings: bool,
                     dtype) -> Level:
    g = aln.open_genome(cur)
    cg = aln.open_genome(nxt)
    slot = aln.tree.child_index(cur, nxt)
    n_seg = g.num_bottom_segments
    nd = cg.num_top_segments
    np_dtype = _np_dtype_of(dtype)
    max_ring = 0
    rc = np.zeros(nd, np.int64)
    ro = np.zeros(nd, np.int64)
    rm = np.zeros(0, np.int64)
    rf = np.zeros(0, np.uint8)
    if rings and (cg.top_paralogy != NULL_INDEX).any():
        rc, ro, rm, rf = _build_ring_csr(cg.top_paralogy,
                                         cg.top_parent_reversed)
        max_ring = int(rc.max()) + 1
    link = (g.bot_child[:n_seg, slot] if n_seg
            else np.zeros(0, np.int64))
    lrev = (g.bot_child_reversed[:n_seg, slot].astype(np.int64)
            if n_seg else np.zeros(0, np.int64))
    mem = rm.astype(np.int64)
    pt, ps = _pages(g.bot_start)
    return Level(
        kind="down",
        grid=jnp.asarray(np.ascontiguousarray(g.bot_start), dtype),
        seg_table=_seg_tab(np_dtype, g.bot_start, link, lrev,
                           cg.top_start[:nd], rc[:nd], ro[:nd]),
        ring_mem_tab=_pack4(np_dtype,
                            cg.top_start[mem] if len(mem) else mem,
                            cg.top_start[mem + 1] if len(mem) else mem,
                            rf.astype(np.int64)),
        max_ring=max_ring,
        page_tab=pt, page_shift=ps,
    )


def build_selfring_level(aln: Alignment, cur: str, dtype) -> Level:
    """Self-ring level for the device column engine (hal_tpu.ops.column_jax):
    split fragments at `cur`'s TOP grid (the parse transition), identity
    link (dst = own segment), ring CSR keyed by the fragment's OWN top
    segment — expanding exactly the reference's toNextParalogy walk from
    the segment itself (halColumnIterator.cpp:642-682 updateNextTopDup).
    The caller drops the pass-through base fragments after expansion
    (members only, matching the ring walk's exclusion of the start
    segment)."""
    g = aln.open_genome(cur)
    nt = g.num_top_segments
    np_dtype = _np_dtype_of(dtype)
    rc = np.zeros(nt, np.int64)
    ro = np.zeros(nt, np.int64)
    rm = np.zeros(0, np.int64)
    rf = np.zeros(0, np.uint8)
    max_ring = 0
    if g.top_paralogy.shape[0] and (g.top_paralogy != NULL_INDEX).any():
        rc, ro, rm, rf = _build_ring_csr(g.top_paralogy,
                                         g.top_parent_reversed)
        max_ring = int(rc.max()) + 1
    mem = rm.astype(np.int64)
    pt, ps = _pages(g.top_start)
    ident = np.arange(nt, dtype=np.int64)
    return Level(
        kind="down",
        grid=jnp.asarray(np.ascontiguousarray(g.top_start), dtype),
        seg_table=_seg_tab(np_dtype, g.top_start, ident,
                           np.zeros(nt, np.int64), g.top_start[:nt],
                           rc[:nt], ro[:nt]),
        ring_mem_tab=_pack4(np_dtype,
                            g.top_start[mem] if len(mem) else mem,
                            g.top_start[mem + 1] if len(mem) else mem,
                            rf.astype(np.int64)),
        max_ring=max_ring,
        page_tab=pt, page_shift=ps,
    )


def _level_flatten(lv: Level):
    children = (lv.grid, lv.seg_table, lv.ring_mem_tab, lv.page_tab)
    aux = (lv.kind, lv.max_ring, lv.page_shift)
    return children, aux


def _level_unflatten(aux, children):
    return Level(kind=aux[0], max_ring=aux[1], page_shift=aux[2],
                 grid=children[0], seg_table=children[1],
                 ring_mem_tab=children[2], page_tab=children[3])


jax.tree_util.register_pytree_node(Level, _level_flatten, _level_unflatten)


def _path_flatten(p: PathData):
    return (p.levels, p.para), (p.n_up, p.min_length)


def _path_unflatten(aux, children):
    return PathData(levels=children[0], para=children[1], n_up=aux[0],
                    min_length=aux[1])


jax.tree_util.register_pytree_node(PathData, _path_flatten, _path_unflatten)


def _build_ring_csr(ring: np.ndarray, reversed_: np.ndarray):
    """Host precompute: per top segment, the OTHER members of its paralogy
    ring (ring order starting after the segment) plus an orientation-flip
    bit per member (TopSegmentIterator::toNextParalogy semantics)."""
    n = len(ring)
    counts = np.zeros(n, np.int64)
    members: list[int] = []
    flips: list[int] = []
    offsets = np.zeros(n, np.int64)
    for i in np.flatnonzero(ring != NULL_INDEX):
        offsets[i] = len(members)
        j = int(ring[i])
        c = 0
        while j != i and j != NULL_INDEX:
            members.append(j)
            flips.append(1 if reversed_[j] != reversed_[i] else 0)
            c += 1
            j = int(ring[j])
        counts[i] = c
    return (counts, offsets, np.asarray(members, np.int64),
            np.asarray(flips, np.uint8))


# --------------------------------------------------------------------------
# jit building blocks (all fixed-capacity)
# --------------------------------------------------------------------------

def _rows(M):
    """Split a packed (r, c) matrix into r dense 1-D rows via one logical
    flatten — XLA emits a single tiled transpose-copy instead of r separate
    (c, 1) layout conversions (which pad the lane axis 128x)."""
    r, c = M.shape
    flat = M.reshape(r * c)
    return [jax.lax.slice_in_dim(flat, f * c, (f + 1) * c) for f in range(r)]


def _expand_owner(counts, cap_out):
    """own[j] = index i of the input owning output slot j, for the dense
    expansion where input i owns counts[i] consecutive slots.

    scatter-max an input-index mark at each segment start, then cummax —
    O(n + cap) memory-bound, no sort.  The two prefix scans are XLA's; on
    an H100 they take about 3% of a liftover batch's device time (PERF.md).

    Index math runs in int32 regardless of the coordinate dtype (counts and
    capacities are < 2^31 always).  Returns (own int32, offsets int32,
    total int32)."""
    dt = counts.dtype
    if dt != jnp.int32:
        counts = counts.astype(jnp.int32)
    offsets = jnp.cumsum(counts) - counts
    total = offsets[-1] + counts[-1]
    n = counts.shape[0]
    idx = jnp.where(counts > 0, offsets, cap_out)
    marks = jnp.zeros(cap_out, jnp.int32).at[idx].max(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    own = jax.lax.cummax(marks)
    return own, offsets, total


def _split_hop(level: Level, F, cap_out, min_length: int = 0):
    """Split fragment targets at this level's segment grid, then hop each
    piece across the link (up: top->parent bottom; down: bottom->child top).

    Returns the hopped packed state (8, cap_out) with C_AUX = destination
    segment start (needed by the ring expansion), plus per-slot ring counts
    and CSR offsets, and the overflow flag."""
    dt = F.dtype
    m = level.seg_table.shape[1]
    t_lo = F[C_TLO]
    t_hi = F[C_THI]
    valid = F[C_VALID] > 0
    i0 = _searchsorted_right(level.grid, t_lo, level.page_tab,
                             level.page_shift) - 1
    i1 = _searchsorted_right(level.grid, t_hi - 1, level.page_tab,
                             level.page_shift) - 1
    # unsigned dtypes wrap on i1 < i0 / garbage inputs; the where() masks
    # every wrapped value before it feeds the expansion
    counts = jnp.where(valid & (i1 >= i0), i1 - i0 + 1, 0)
    own, offsets, total = _expand_owner(counts, cap_out)
    # gather-once source matrix: [s_lo, s_hi, t_lo, t_hi, rev, owner, offset, i0]
    G = jnp.concatenate([F[:6], offsets[None, :].astype(dt),
                         i0[None, :]], axis=0)
    R = _rows(jnp.take(G, own, axis=1))  # one column gather, then dense rows
    j = jnp.arange(cap_out, dtype=dt)
    k = j - R[6]
    seg = jnp.clip(R[7] + k, 0, m - 1)
    # one gather: [start, next, dst_start, lrev, has_link, ring_count, ring_offset]
    ST = _rows(jnp.take(level.seg_table, seg, axis=1))
    p_lo = jnp.maximum(R[C_TLO], ST[0])
    p_hi = jnp.minimum(R[C_THI], ST[1])
    rev = R[C_REV]
    adv = jnp.where(rev > 0, R[C_THI] - p_hi, p_lo - R[C_TLO])
    s_lo = R[C_SLO] + adv
    ln = p_hi - p_lo
    in_range = j < total.astype(dt)
    v = in_range & (p_hi > p_lo) & (ln >= max(min_length, 1))
    # hop across the (pre-joined) link
    lrev = ST[3]
    has = v & (ST[4] > 0)
    ds = ST[2]
    off = p_lo - ST[0]
    mirrored = ST[1] - p_hi
    new_lo = jnp.where(lrev > 0, ds + mirrored, ds + off)
    new_rev = rev ^ lrev
    Fout = jnp.stack(
        [s_lo, s_lo + ln, new_lo, new_lo + ln, new_rev, R[C_OWN],
         has.astype(dt), ds], axis=0)
    ring_counts = jnp.where(has, ST[5], 0)
    ring_offsets = ST[6]
    return Fout, ring_counts, ring_offsets, total, total > cap_out


def _ring_expand(level: Level, F, ring_counts, ring_offsets, cap_out):
    """Append all paralogy-ring members via one CSR expansion (bounded by
    the true number of dupes).  F's C_AUX row holds the destination
    segment start from the hop."""
    dt = F.dtype
    own, offsets, total = _expand_owner(ring_counts, cap_out)
    off_row = F[C_TLO] - F[C_AUX]
    ln_row = F[C_THI] - F[C_TLO]
    G = jnp.concatenate(
        [F[:2], off_row[None, :], ln_row[None, :], F[4:6],
         offsets[None, :].astype(dt), ring_offsets[None, :]], axis=0)
    R = _rows(jnp.take(G, own, axis=1))
    j = jnp.arange(cap_out, dtype=dt)
    k = j - R[6]
    nnz = max(level.ring_mem_tab.shape[1], 1)
    midx = jnp.clip(R[7] + k, 0, nnz - 1)
    MT = _rows(jnp.take(level.ring_mem_tab, midx, axis=1))  # [start, next, flip]
    offm = R[2]
    ln = R[3]
    flip = MT[2]
    nlo = jnp.where(flip > 0, MT[1] - offm - ln, MT[0] + offm)
    v = j < total.astype(dt)
    F2 = jnp.stack(
        [R[0], R[1], nlo, nlo + ln, R[4] ^ flip, R[5],
         v.astype(dt), jnp.zeros_like(nlo)], axis=0)
    return jnp.concatenate([F, F2], axis=1), total, total > cap_out


def _final_bound(F):
    """Last-valid bound: the host transfers F[:, :bound] and filters by the
    valid row (no argsort compaction on device)."""
    valid = F[C_VALID] > 0
    idx = jnp.arange(valid.shape[0], dtype=jnp.int32)
    return jnp.max(jnp.where(valid, idx + 1, 0))


def _run_path(path: PathData, lo, hi, owner, caps, level_xform=None):
    """Trace the whole path; returns the packed (8, cap) fragment matrix
    [s_lo, s_hi, t_lo, t_hi, rev, owner, valid, aux], the last-valid bound,
    the overflow flag and per-level valid totals.

    caps is consumed in traversal order: one per up level, then per
    paralogy-branch hop (up + each down incl. ring), then per main down
    level (split cap or (split, ring) tuple).

    level_xform: optional Level -> Level hook applied as each level is
    consumed — the table-sharded SPMD step uses it to all-gather a level's
    segment tables right before the hop (FSDP-style: tables rest
    sharded 1/D per device; see parallel.sharded.make_table_sharded_step)."""
    n = lo.shape[0]
    dt = lo.dtype
    ml = path.min_length
    z = jnp.zeros(n, dt)
    F = jnp.stack([lo, hi, lo, hi, z, owner, (hi > lo).astype(dt), z], axis=0)
    overflow = jnp.asarray(False)
    level_totals = []
    caps = list(caps)
    cap_i = 0

    def next_cap():
        nonlocal cap_i
        c = caps[cap_i]
        cap_i += 1
        return c if isinstance(c, tuple) else (c, c)

    def apply_level(level, F):
        nonlocal overflow
        if level_xform is not None:
            level = level_xform(level)
        split_cap, ring_cap = next_cap()
        F, ring_counts, ring_offsets, stot, ov1 = _split_hop(level, F,
                                                             split_cap, ml)
        overflow |= ov1
        sv = stot.astype(jnp.int32)
        rv = jnp.zeros((), jnp.int32)
        if level.kind == "down" and level.max_ring > 0:
            F, rtot, ov2 = _ring_expand(level, F, ring_counts, ring_offsets,
                                        ring_cap)
            overflow |= ov2
            rv = rtot.astype(jnp.int32)
        level_totals.append(jnp.stack([sv, rv]))
        return F

    for level in path.levels[:path.n_up]:
        F = apply_level(level, F)

    if path.para:
        # paralogy branches above the MRCA: chain up, fan each branch back
        # down with rings, union with the MRCA fragments
        branches = [F]
        G = F
        for (up, downs) in path.para:
            G = apply_level(up, G)
            H = G
            for dlv in downs:
                H = apply_level(dlv, H)
            branches.append(H)
        F = jnp.concatenate(branches, axis=1)

    for level in path.levels[path.n_up:]:
        F = apply_level(level, F)

    bound = _final_bound(F)
    return F, bound, overflow, (jnp.stack(level_totals) if level_totals
                                else jnp.zeros((0, 2), jnp.int32))


@functools.partial(jax.jit, static_argnames=("caps",))
def _map_batch_jit(path: PathData, lo, hi, owner, caps):
    return _run_path(path, lo, hi, owner, caps)


@jax.jit
def _compact_jit(F):
    """Scatter-compact valid fragment columns to the front; returns the
    compacted (6, cap) result matrix (aux rows dropped) and the valid
    count — the host then transfers exactly count columns instead of the
    padded capacity."""
    valid = F[C_VALID] > 0
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    total = jnp.where(valid.shape[0] > 0, pos[-1] + 1, 0)
    idx = jnp.where(valid, pos, F.shape[1])  # invalid -> dropped
    out = jnp.zeros_like(F[:6]).at[:, idx].set(F[:6], mode="drop")
    return out, total


@jax.jit
def _compact_packed_jit(F):
    """Compaction with a transfer-minimal encoding: coordinates stay int64
    but length/rev/owner drop to one int32 row each —
    (coords (2, cap) int64 [s_lo, t_lo], meta (3, cap) int32
    [len, rev, owner], count).  Halves device->host bytes vs the full
    (6, cap) int64 matrix; reconstruct with s_hi = s_lo + len,
    t_hi = t_lo + len."""
    valid = F[C_VALID] > 0
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    total = jnp.where(valid.shape[0] > 0, pos[-1] + 1, 0)
    idx = jnp.where(valid, pos, F.shape[1])
    coords = jnp.stack([F[C_SLO], F[C_TLO]], axis=0)
    meta = jnp.stack([F[C_SHI] - F[C_SLO], F[C_REV], F[C_OWN]],
                     axis=0).astype(jnp.int32)
    out_c = jnp.zeros_like(coords).at[:, idx].set(coords, mode="drop")
    out_m = jnp.zeros_like(meta).at[:, idx].set(meta, mode="drop")
    return out_c, out_m, total


@functools.partial(jax.jit, static_argnames=("out_cols", "len_bits"))
def _compact_u32_fixed_jit(F, out_cols, len_bits):
    """Transfer-minimal compaction for 32-bit paths: THREE uint32 rows
    [s_lo, t_lo, owner<<(len_bits+1) | len<<1 | rev] scatter-compacted into
    a STATIC (3, out_cols) matrix — 12 bytes/row, one D2H fetch, and the
    output shape is known on host (host_final_total) so no device slice op
    has to queue behind pending batches at drain time.

    Requires len < 2^len_bits and owner < 2^(31-len_bits) — the caller
    checks applicability (fits_u32_fixed); the kernel still flags overflow
    when a row violates the packing at runtime."""
    valid = F[C_VALID] > 0
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    total = jnp.where(valid.shape[0] > 0, pos[-1] + 1, 0)
    idx = jnp.where(valid, pos, out_cols)
    s_lo = F[C_SLO].astype(jnp.uint32)
    t_lo = F[C_TLO].astype(jnp.uint32)
    ln = (F[C_SHI] - F[C_SLO]).astype(jnp.uint32)
    rev = F[C_REV].astype(jnp.uint32) & 1
    own = F[C_OWN].astype(jnp.uint32)
    packed = (own << (len_bits + 1)) | (ln << 1) | rev
    rows = jnp.stack([s_lo, t_lo, packed], axis=0)
    out = jnp.zeros((3, out_cols), jnp.uint32).at[:, idx].set(rows, mode="drop")
    bad = valid & ((ln >= (1 << len_bits)) | (own >= (1 << (31 - len_bits))))
    ovf = (total > out_cols) | jnp.any(bad)
    return out, total, ovf


@functools.partial(jax.jit,
                   static_argnames=("out_cols", "len_bits", "exc_cap"))
def _runs_packed_jit(F, lo, seq_grid, out_cols, len_bits, exc_cap=None):
    """Device run extraction + transfer-minimal packing — the device-side
    equivalent of BlockMapper::extractSegment
    (reference liftover/impl/halBlockMapper.cpp:331-391): merge
    target-abutting, source-abutting, same-orientation fragment chains
    BEFORE anything crosses the device->host link.

    Fragments are sorted by (owner, t_lo) — the MappedSegmentSet order
    within an owner (halMappedSegment.cpp:167-206) — then chains are
    reduced with segmented scatter-adds.  Owners containing duplicate
    target starts (paralogy dupe classes) are NOT merged on device: their
    raw fragments pass through flagged, and the host applies the exact
    class-merge + query-cut rules (ops.liftover.extract_runs) to just
    those owners, so the combined result equals host extract_runs exactly.

    Returns (t_lo u32 (out_cols), pack u16 (out_cols) = s_off<<len_bits|len,
    rev_bits u8 (out_cols/8), counts u8 (n_owners) runs per owner,
    dupe_bits u8 (n_owners/8) owners needing host merge, run_total i32,
    overflow bool).  All shapes static: the drain never queues a dynamic
    slice behind pending batches.  Requires s_off < 2^(16-len_bits),
    merged len < 2^len_bits, runs/owner < 256 (overflow-flagged)."""
    n_own = lo.shape[0]
    cap = F.shape[1]
    valid = F[C_VALID] > 0
    u = jnp.uint32
    own_k = jnp.where(valid, F[C_OWN].astype(u), u(0xFFFFFFFF))
    tlo = F[C_TLO].astype(u)
    ln = (F[C_SHI] - F[C_SLO]).astype(u)
    rev = F[C_REV].astype(u) & u(1)
    # source coordinates enter the sort OWNER-RELATIVE and pre-packed with
    # (len, rev) into one u32 — 3 sort operands instead of 5 (the 2-key
    # bitonic sort is the packing kernel's dominant cost); same-owner
    # differences are what the merge predicate needs, so offsets suffice
    own_lo_in = jnp.take(lo.astype(u),
                         jnp.clip(F[C_OWN].astype(jnp.int32), 0, n_own - 1))
    s_off_in = F[C_SLO].astype(u) - own_lo_in
    bad_in = valid & ((ln >= (u(1) << len_bits))
                      | (s_off_in >= (u(1) << (16 - len_bits))))
    meta = (s_off_in << (len_bits + 1)) | (ln << 1) | rev
    own_s, tlo_s, meta_s = jax.lax.sort(
        (own_k, tlo, meta), num_keys=2, is_stable=True)
    soff_s = meta_s >> (len_bits + 1)
    ln_s = (meta_s >> 1) & ((u(1) << len_bits) - u(1))
    rev_s = meta_s & u(1)
    valid_s = own_s != u(0xFFFFFFFF)
    # dupe classes: equal (owner, t_lo) pairs -> flag the whole owner
    prev_own = jnp.concatenate([u(0xFFFFFFFF)[None], own_s[:-1]])
    prev_tlo = jnp.concatenate([u(0)[None], tlo_s[:-1]])
    prev_soff = jnp.concatenate([u(0)[None], soff_s[:-1]])
    prev_ln = jnp.concatenate([u(0)[None], ln_s[:-1]])
    prev_rev = jnp.concatenate([u(0)[None], rev_s[:-1]])
    same_own = own_s == prev_own
    # any target overlap within an owner (the device F is un-atomized, so
    # paralogy dupes may overlap without sharing a start; equal starts are
    # the degenerate case) -> flag the owner for host-side atomize+merge
    dup_pair = same_own & (tlo_s < prev_tlo + prev_ln) & valid_s
    own_idx = jnp.where(valid_s, own_s, u(n_own)).astype(jnp.int32)
    dup_own = jnp.zeros(n_own, jnp.int32).at[own_idx].max(
        dup_pair.astype(jnp.int32), mode="drop")
    row_dup = jnp.take(dup_own, jnp.clip(own_idx, 0, n_own - 1)) > 0
    # chain-merge predicate (canMergeRightWith, halMappedSegment.cpp:109-161);
    # runs never span target sequences (extract_runs seq_index_of check)
    abut_t = tlo_s == prev_tlo + prev_ln
    abut_s = jnp.where(rev_s > 0, prev_soff == soff_s + ln_s,
                       soff_s == prev_soff + prev_ln)
    seq_id = jnp.searchsorted(seq_grid, tlo_s, side="right")
    prev_seq = jnp.concatenate([seq_id[:1] * 0, seq_id[:-1]])
    mergeable = (same_own & (rev_s == prev_rev) & abut_t & abut_s
                 & (seq_id == prev_seq) & ~row_dup & valid_s)
    start = valid_s & ~mergeable
    rid0 = jnp.cumsum(start.astype(jnp.int32)) - 1
    run_total = jnp.where(cap > 0, rid0[-1] + 1, 0)
    rid = jnp.where(valid_s, rid0, out_cols)
    # segmented reduction per run
    out_tlo = jnp.zeros(out_cols, u).at[rid].max(
        jnp.where(start, tlo_s, u(0)), mode="drop")
    out_soff = jnp.full(out_cols, u(0xFFFFFFFF)).at[rid].min(
        jnp.where(valid_s, soff_s, u(0xFFFFFFFF)), mode="drop")
    out_len = jnp.zeros(out_cols, u).at[rid].add(ln_s, mode="drop")
    out_rev = jnp.zeros(out_cols, u).at[rid].max(
        jnp.where(start, rev_s, u(0)), mode="drop")
    # per-owner run counts (2-bit wire codes; overflow-flagged)
    counts32 = jnp.zeros(n_own, jnp.int32).at[own_idx].add(
        start.astype(jnp.int32), mode="drop")
    in_run = jnp.arange(out_cols, dtype=jnp.int32) < run_total
    s_off = jnp.where(in_run, out_soff, u(0))
    pack = s_off << len_bits | jnp.where(in_run, out_len, u(0))
    overflow = ((run_total > out_cols)
                | jnp.any(bad_in)
                | jnp.any(counts32 > 255)
                | jnp.any(in_run & (out_len >= (u(1) << len_bits)))
                | jnp.any(in_run & (s_off >= (u(1) << (16 - len_bits)))))

    # ---- single u32 wire buffer (ONE D2H fetch per batch): t_lo words,
    # u16 pack pairs, rev bitset, run-count encoding, dupe bitset — all
    # little-endian within words so the host decodes with numpy views.
    #
    # Run counts ship as a ones-BITMAP + exception byte stream (VERDICT
    # r4 next #2b): ~99% of owners map to exactly one run at bench
    # density, so 1 B/owner shrinks to 1 bit/owner + a u8 per exceptional
    # owner (0 or >=2 runs), compacted on device.  The exception region
    # is statically n_own/8 bytes; more exceptions than that flags
    # overflow (the caller falls back to exact sizing).
    def padto(v, m):
        r = (-v.shape[0]) % m
        return jnp.pad(v, (0, r)) if r else v

    def bits32(v):  # 0/1 -> packed u32 words, little-endian bit order
        b = padto(v, 32).reshape(-1, 32)
        return (b << jnp.arange(32, dtype=u)[None, :]).sum(
            axis=1, dtype=u)

    def bytes4(v):  # u8-range -> packed u32 words, little-endian
        b = padto(v, 4).reshape(-1, 4)
        return (b << (jnp.arange(4, dtype=u) * 8)[None, :]).sum(
            axis=1, dtype=u)

    codes = jnp.minimum(counts32, 3)           # 2-bit count code, 3=escape
    esc = codes == 3
    if exc_cap is None:
        exc_cap = _exc_cap(n_own)
    exc_pos = jnp.cumsum(esc.astype(jnp.int32)) - 1
    n_exc = jnp.where(n_own > 0, exc_pos[-1] + 1, 0)
    exc_idx = jnp.where(esc, exc_pos, exc_cap)
    exc_vals = jnp.zeros(exc_cap, u).at[exc_idx].set(
        jnp.minimum(counts32, 255).astype(u), mode="drop")
    overflow = overflow | (n_exc > exc_cap)

    def crumbs32(v):  # 2-bit codes -> packed u32 words, little-endian
        b = padto(v, 16).reshape(-1, 16)
        return (b << (jnp.arange(16, dtype=u) * 2)[None, :]).sum(
            axis=1, dtype=u)

    p2 = padto(pack, 2).reshape(-1, 2)
    wire = jnp.concatenate([
        jnp.where(in_run, out_tlo, u(0)),
        p2[:, 0] | (p2[:, 1] << 16),
        bits32(jnp.where(in_run, out_rev, u(0))),
        crumbs32(codes.astype(u)),
        bytes4(exc_vals),
        bits32((dup_own > 0).astype(u)),
    ])
    return wire, run_total.astype(jnp.int32), overflow


def target_seq_grid(genome):
    """Inner sequence bounds of a target genome as a device uint32 grid for
    _runs_packed_jit's never-span-sequences check; single-sequence genomes
    get one unreachable sentinel (jnp.searchsorted rejects empty grids)."""
    inner = np.asarray(genome.seq_start[1:-1], np.int64)
    if inner.size == 0:
        inner = np.array([0xFFFFFFFF], np.int64)
    return jnp.asarray(inner, jnp.uint32)


def _exc_cap(n_own: int) -> int:
    """Static size of the run-count escape region: only owners with >= 3
    runs escape the 2-bit code (rare — an owner needs two+ break points
    inside one query interval), but never less than full coverage for
    small batches."""
    return max(n_own // 32, min(n_own, 4096), 4)


def wire_words(out_cols: int, n_own: int) -> int:
    """Length in u32 words of _runs_packed_jit's wire buffer."""
    exc_cap = _exc_cap(n_own)
    return (out_cols + (out_cols + 1) // 2 + (out_cols + 31) // 32
            + (n_own + 15) // 16 + (exc_cap + 3) // 4
            + (n_own + 31) // 32)


def decode_runs_packed(wire, run_total, lo, out_cols: int, len_bits: int,
                       exc_cap: int | None = None):
    """Host decode of _runs_packed_jit's single u32 wire buffer: returns
    int64 numpy arrays (s_lo, s_hi, t_lo, t_hi, rev, owner) of the merged
    runs plus the boolean per-owner needs-host-merge mask."""
    k = int(run_total)
    n_own = len(lo)
    w = np.asarray(wire)
    c = out_cols
    c2 = (c + 1) // 2
    cb = (c + 31) // 32
    nb = (n_own + 15) // 16
    if exc_cap is None:
        exc_cap = _exc_cap(n_own)
    e4 = (exc_cap + 3) // 4
    tl = w[:c][:k].astype(np.int64)
    pw = w[c:c + c2]
    pack = np.empty(c2 * 2, np.int64)
    pack[0::2] = pw & 0xFFFF
    pack[1::2] = pw >> 16
    pack = pack[:k]
    ln = pack & ((1 << len_bits) - 1)
    s_off = pack >> len_bits
    rb = np.unpackbits(w[c + c2:c + c2 + cb].view(np.uint8),
                       bitorder="little")[:k]
    o = c + c2 + cb
    cw = w[o:o + nb]
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    codes = ((cw[:, None] >> shifts) & 3).reshape(-1)[:n_own].astype(np.int64)
    exc = w[o + nb:o + nb + e4].view(np.uint8)
    counts = codes.copy()
    esc = codes == 3
    n_exc = int(esc.sum())
    counts[esc] = exc[:n_exc].astype(np.int64)
    dupes = np.unpackbits(w[o + nb + e4:].view(np.uint8),
                          bitorder="little")[:n_own].astype(bool)
    own = np.repeat(np.arange(n_own, dtype=np.int64), counts)
    assert len(own) == k, (len(own), k)
    s_lo = np.asarray(lo, np.int64)[own] + s_off
    return (s_lo, s_lo + ln, tl, tl + ln, rb.astype(np.int64), own, dupes)


def decode_u32_fixed(M: np.ndarray, count: int, len_bits: int):
    """Host-side decode of _compact_u32_fixed_jit output: returns int64
    (s_lo, s_hi, t_lo, t_hi, rev, owner) numpy arrays."""
    M = np.asarray(M)[:, :count].astype(np.int64)
    s_lo, t_lo, packed = M[0], M[1], M[2]
    rev = packed & 1
    ln = (packed >> 1) & ((1 << len_bits) - 1)
    own = packed >> (len_bits + 1)
    return s_lo, s_lo + ln, t_lo, t_lo + ln, rev, own


def enable_compile_cache() -> None:
    """Persistent XLA compilation cache: the first compile of each
    (program, caps) pair is written to disk and later processes load it.
    Call before the first jit dispatch.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX places the cache there
    itself and this sets no directory; otherwise the cache is the fixed
    <repo>/.jax_cache (gitignored)."""
    import os

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        d = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:  # read-only checkout: run without a cache
            return
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def _bucket_cap(x: int) -> int:
    """Round up to a quarter-octave bucket ({4,5,6,7} * 2^k): at most 25%
    slack instead of pow2's 100%, while keeping the compile-cache key space
    finite."""
    x = max(int(x), 16)
    base = 1 << max(x.bit_length() - 1, 2)  # largest pow2 <= x
    quarter = base >> 2
    for m in (4, 5, 6, 7, 8):
        c = m * quarter
        if c >= x:
            return c
    return 2 * base


class _HostSim:
    """Host twin of _run_path's split/hop/ring algebra (numpy, exact).

    Sizes device capacities without a device sizing pass; also yields the
    exact final row count for static-output compaction.  Ring CSR tables
    are cached per child genome so multi-path sizing (depth over a whole
    scope) builds each at most once."""

    def __init__(self, aln: Alignment, do_dupes: bool = True):
        self.aln = aln
        self.tree = aln.tree
        self.do_dupes = do_dupes
        self._csr: dict = {}

    def _rings(self, child_name: str):
        r = self._csr.get(child_name)
        if r is None:
            cg = self.aln.open_genome(child_name)
            if (self.do_dupes and cg.top_paralogy.size
                    and (cg.top_paralogy != NULL_INDEX).any()):
                rc, ro, rm, rf = _build_ring_csr(cg.top_paralogy,
                                                 cg.top_parent_reversed)
                r = (rc, ro, rm, rf, cg.top_start)
            else:
                r = False
            self._csr[child_name] = r
        return r

    def level(self, cur: str, nxt: str, t_lo, t_hi, rings: bool):
        """Apply one level; returns (t_lo', t_hi', split_total, ring_total)."""
        g = self.aln.open_genome(cur)
        ng = self.aln.open_genome(nxt)
        going_up = self.tree.parent(cur) == nxt
        ring_count = None
        if going_up:
            starts = g.top_start
            link = g.top_parent
            lrev = g.top_parent_reversed.astype(np.int64)
            dst = ng.bot_start
        else:
            slot = self.tree.child_index(cur, nxt)
            starts = g.bot_start
            link = (g.bot_child[:, slot] if g.num_bottom_segments
                    else np.zeros(0, np.int64))
            lrev = (g.bot_child_reversed[:, slot].astype(np.int64)
                    if g.num_bottom_segments else np.zeros(0, np.int64))
            dst = ng.top_start
            if rings:
                ring_count = self._rings(nxt) or None
        i0 = np.searchsorted(starts, t_lo, side="right") - 1
        i1 = np.searchsorted(starts, t_hi - 1, side="right") - 1
        counts = np.maximum(i1 - i0 + 1, 0) * (t_hi > t_lo)
        split_total = int(counts.sum())
        own = np.repeat(np.arange(len(counts)), counts)
        offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
        seg = i0[own] + (np.arange(len(own)) - offs[own])
        p_lo = np.maximum(t_lo[own], starts[seg])
        p_hi = np.minimum(t_hi[own], starts[seg + 1])
        li = link[seg] if len(link) else np.full(len(seg), NULL_INDEX)
        keep = (p_hi > p_lo) & (li != NULL_INDEX)
        seg, p_lo, p_hi, li = seg[keep], p_lo[keep], p_hi[keep], li[keep]
        lr = lrev[seg] if len(lrev) else np.zeros(len(seg), np.int64)
        ds = dst[li]
        off = p_lo - starts[seg]
        mirrored = starts[seg + 1] - p_hi
        new_lo = np.where(lr > 0, ds + mirrored, ds + off)
        ln = p_hi - p_lo
        t_lo2, t_hi2 = new_lo, new_lo + ln
        ring_total = 0
        if ring_count is not None:
            rc, ro, rm, rf, cstarts = ring_count
            rcs = rc[li]
            ring_total = int(rcs.sum())
            rown = np.repeat(np.arange(len(rcs)), rcs)
            roffs = np.concatenate([[0], np.cumsum(rcs)])[:-1]
            midx = rm[ro[li][rown] + (np.arange(len(rown)) - roffs[rown])]
            offm = t_lo2[rown] - cstarts[li[rown]]
            mln = ln[rown]
            flip = rf[ro[li][rown] + (np.arange(len(rown)) - roffs[rown])]
            nlo = np.where(flip > 0, cstarts[midx + 1] - offm - mln,
                           cstarts[midx] + offm)
            t_lo2 = np.concatenate([t_lo2, nlo])
            t_hi2 = np.concatenate([t_hi2, nlo + mln])
        return t_lo2, t_hi2, split_total, ring_total


def host_level_totals(aln: Alignment, src: str, tgt: str, lo, hi,
                      do_dupes: bool = True, with_final: bool = False,
                      sim: "_HostSim | None" = None):
    """Exact per-level expansion totals for a MAIN-CHAIN path, computed on
    host with numpy in one vectorized pass per level (mirrors _run_path's
    split/ring algebra via _HostSim).

    Replaces the device 'sizing pass' — a separate generous-caps compile
    that dominated round-1 bench time — so the device program compiles
    ONCE with tight power-of-two caps.  Returns [(split_total, ring_total)]
    per level; with_final=True returns (totals, final_valid_rows) where
    final_valid_rows is the exact post-filter fragment count the device
    compaction will produce (sizes _compact_u32_fixed_jit's static
    output)."""
    if sim is None:
        sim = _HostSim(aln, do_dupes)
    tree = aln.tree
    t_lo = np.asarray(lo, np.int64)
    t_hi = np.asarray(hi, np.int64)
    totals = []
    cur = src
    for nxt in tree.path(src, tgt)[1:]:
        t_lo, t_hi, sv, rv = sim.level(cur, nxt, t_lo, t_hi,
                                       rings=do_dupes)
        totals.append((sv, rv))
        cur = nxt
    if with_final:
        return totals, len(t_lo)
    return totals


def host_path_totals(aln: Alignment, src: str, tgt: str, lo, hi,
                     do_dupes: bool = True,
                     coalescence_limit: str | None = None,
                     sim: "_HostSim | None" = None):
    """Exact expansion totals for the FULL _run_path traversal order —
    up levels, paralogy branches above the MRCA (coalescence limit,
    reference mapRecursiveParalogies halSegmentMapper.cpp:525-576), then
    main down levels on the unioned fragment set.  One (sv, rv) entry per
    cap _run_path consumes, so caps_from_totals sizes every program
    exactly and device overflow becomes a hard invariant violation."""
    if sim is None:
        sim = _HostSim(aln, do_dupes)
    tree = aln.tree
    mrca = tree.lca(src, tgt)
    limit = coalescence_limit or mrca
    chain = [mrca]
    anc = mrca
    while anc != limit:
        anc = tree.parent(anc)
        if anc is None:
            raise ValueError("coalescence limit %s is not an ancestor of "
                             "the MRCA %s" % (limit, mrca))
        chain.append(anc)
    t_lo = np.asarray(lo, np.int64)
    t_hi = np.asarray(hi, np.int64)
    totals = []
    cur = src
    while cur != mrca:
        nxt = tree.parent(cur)
        t_lo, t_hi, sv, rv = sim.level(cur, nxt, t_lo, t_hi, rings=do_dupes)
        totals.append((sv, rv))
        cur = nxt
    if do_dupes and limit != mrca:
        branches = [(t_lo, t_hi)]
        g_lo, g_hi = t_lo, t_hi
        for k in range(1, len(chain)):
            g_lo, g_hi, sv, rv = sim.level(chain[k - 1], chain[k], g_lo,
                                           g_hi, rings=False)
            totals.append((sv, rv))
            h_lo, h_hi = g_lo, g_hi
            for j in range(k - 1, -1, -1):
                h_lo, h_hi, sv, rv = sim.level(chain[j + 1], chain[j], h_lo,
                                               h_hi, rings=True)
                totals.append((sv, rv))
            branches.append((h_lo, h_hi))
        t_lo = np.concatenate([b[0] for b in branches])
        t_hi = np.concatenate([b[1] for b in branches])
    if cur != tgt:
        for nxt in tree.path(cur, tgt)[1:]:
            t_lo, t_hi, sv, rv = sim.level(cur, nxt, t_lo, t_hi,
                                           rings=do_dupes)
            totals.append((sv, rv))
            cur = nxt
    return totals, len(t_lo)


def caps_from_totals(path: PathData, totals, slack: float = 1.0):
    """Quarter-octave bucketed caps for the FULL traversal (up levels,
    paralogy branches, main down levels) from host_path_totals output —
    one cap per level in _run_path's consumption order."""
    seq = list(path.levels[:path.n_up])
    for (up, downs) in path.para:
        seq.append(up)
        seq.extend(downs)
    seq.extend(path.levels[path.n_up:])
    assert len(seq) == len(totals), (len(seq), len(totals))
    caps = []
    for level, (sv, rv) in zip(seq, totals):
        c = _bucket_cap(int(sv * slack))
        if level.kind == "down" and level.max_ring:
            caps.append((c, _bucket_cap(int(rv * slack))))
        else:
            caps.append(c)
    return tuple(caps)


def tight_caps(path: PathData, totals, slack: float = 1.0):
    """Quarter-octave bucketed caps from host_level_totals output
    (main-chain paths only; full paths use caps_from_totals)."""
    assert not path.para, "tight_caps sizes main-chain paths only"
    return caps_from_totals(path, totals, slack)


class BatchMapper:
    """Dispatch/decode-split map_batch for PIPELINED batch streams: the
    caller dispatches batch k+1 before decoding batch k, so the D2H drain
    of one batch overlaps the device execution of the next (the reference
    pays zero transfer, halBlockLiftover.cpp:46-113, so every hidden
    drain second is headline time)."""

    def __init__(self, aln: Alignment, src: str, tgt: str,
                 do_dupes: bool = True, coalescence_limit: str | None = None,
                 min_length: int = 0):
        self.path = PathData.build(aln, src, tgt, do_dupes=do_dupes,
                                   coalescence_limit=coalescence_limit,
                                   min_length=min_length)
        self.dtype = (self.path.levels[0].grid.dtype if self.path.levels
                      else jnp.int64)

    def _caps(self, n: int, mult: int):
        base = max(n, 16)

        def cap_for(level):
            c = _next_pow2(base * mult)
            if level.kind == "down" and level.max_ring:
                return (int(c), _next_pow2(c * min(level.max_ring, 4)))
            return int(c)

        caps = [cap_for(lv) for lv in self.path.levels[:self.path.n_up]]
        for (up, downs) in self.path.para:
            caps.append(cap_for(up))
            caps.extend(cap_for(d) for d in downs)
        caps.extend(cap_for(lv) for lv in self.path.levels[self.path.n_up:])
        return tuple(caps)

    def dispatch(self, lo, hi, owner=None, cap_mult: int = 4):
        """Async device dispatch; returns an opaque pending handle."""
        lo_d = jnp.asarray(lo, self.dtype)
        hi_d = jnp.asarray(hi, self.dtype)
        n = int(lo_d.shape[0])
        own = (jnp.arange(n, dtype=self.dtype) if owner is None
               else jnp.asarray(owner, self.dtype))
        caps = self._caps(n, cap_mult)
        F, bound, ovf, _lt = _map_batch_jit(self.path, lo_d, hi_d, own, caps)
        return (F, bound, ovf, lo_d, hi_d, own, cap_mult)

    def decode(self, pend):
        """Drain one pending batch; on capacity overflow re-runs THAT
        batch synchronously with doubled capacity (rare).  Returns numpy
        (src_lo, src_hi, tgt_lo, tgt_hi, rev, owner)."""
        F, bound, ovf, lo_d, hi_d, own, mult = pend
        while bool(np.asarray(ovf.reshape(1))[0]):
            mult *= 2
            if mult > 4096:
                raise RuntimeError("segment-map capacity blowup")
            caps = self._caps(int(lo_d.shape[0]), mult)
            F, bound, ovf, _lt = _map_batch_jit(self.path, lo_d, hi_d, own,
                                                caps)
        k = int(np.asarray(bound.reshape(1))[0])
        M = np.asarray(F[:, :k]).astype(np.int64)
        mask = M[C_VALID].astype(bool)
        M = M[:, mask]
        return (M[C_SLO], M[C_SHI], M[C_TLO], M[C_THI], M[C_REV], M[C_OWN])


def map_batch(path: PathData, lo, hi, owner=None, cap_mult: int = 4):
    """Host wrapper: run the jitted path, growing capacity on overflow.

    Returns numpy (src_lo, src_hi, tgt_lo, tgt_hi, rev, owner) of valid
    fragments (un-atomized, un-deduped — feed to segmap_host.atomize or the
    bulk liftover emitter)."""
    dtype = path.levels[0].grid.dtype if path.levels else jnp.int64
    lo = jnp.asarray(lo, dtype)
    hi = jnp.asarray(hi, dtype)
    n = int(lo.shape[0])
    if owner is None:
        owner = jnp.arange(n, dtype=dtype)
    else:
        owner = jnp.asarray(owner, dtype)
    mult = cap_mult
    while True:
        base = max(n, 16)

        def cap_for(level):
            c = _next_pow2(base * mult)
            if level.kind == "down" and level.max_ring:
                return (int(c), _next_pow2(c * min(level.max_ring, 4)))
            return int(c)

        caps = [cap_for(lv) for lv in path.levels[:path.n_up]]
        for (up, downs) in path.para:
            caps.append(cap_for(up))
            caps.extend(cap_for(d) for d in downs)
        caps.extend(cap_for(lv) for lv in path.levels[path.n_up:])
        F, bound, overflow, level_totals = _map_batch_jit(path, lo, hi, owner,
                                                          tuple(caps))
        if not bool(np.asarray(overflow.reshape(1))[0]):
            # transfer only up to the last valid slot (the padded capacity
            # stays on device); results convert to int64 so unsigned
            # device dtypes never leak wraparound arithmetic into host
            # callers
            k = int(np.asarray(bound.reshape(1))[0])
            M = np.asarray(F[:, :k]).astype(np.int64)
            mask = M[C_VALID].astype(bool)
            M = M[:, mask]
            return (M[C_SLO], M[C_SHI], M[C_TLO], M[C_THI],
                    M[C_REV], M[C_OWN])
        mult *= 2
        if mult > 4096:
            raise RuntimeError("segment-map capacity blowup")
