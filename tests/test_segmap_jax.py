"""Device (jit) mapper must produce the same fragment content as the host
oracle (un-atomized fragments compared as base-pair sets per owner)."""

import numpy as np
import pytest

from hal_tpu.randgen import create_random_alignment
from hal_tpu.ops import segmap_host as sm
from hal_tpu.ops import segmap_jax as sj
from naive_oracle import fragments_to_base_pairs


def _pairs_with_owner(s_lo, s_hi, t_lo, t_hi, rev, own):
    out = set()
    for i in range(len(s_lo)):
        for k in range(int(s_hi[i] - s_lo[i])):
            tp = int(t_hi[i]) - 1 - k if rev[i] else int(t_lo[i]) + k
            out.add((int(own[i]), int(s_lo[i]) + k, tp, bool(rev[i])))
    return out


def _pairs_to_check(aln, exhaustive):
    """Leaf->leaf, leaf->root, root->leaf by default (covers up, down and
    up+down paths); every ordered pair with HAL_TPU_SLOW_TESTS=1."""
    names = aln.genome_names()
    if exhaustive:
        return [(s, t) for s in names for t in names if s != t]
    leaves = [n for n in names if aln.tree.is_leaf(n)]
    root = aln.root_name
    out = []
    if len(leaves) >= 2:
        out.append((leaves[0], leaves[-1]))
    out.append((leaves[0], root))
    out.append((root, leaves[0]))
    return out


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_jax_matches_host(seed):
    import os

    aln = create_random_alignment(seed=seed, max_genomes=6, min_segments=3,
                                  max_segments=25, min_segment_length=2,
                                  max_segment_length=12)
    rng = np.random.default_rng(seed)
    count = 0
    for src, tgt in _pairs_to_check(aln, os.environ.get("HAL_TPU_SLOW_TESTS") == "1"):
        g = aln.open_genome(src)
        if g.length < 4:
            continue
        if True:
            lo = rng.integers(0, g.length - 2, 8)
            hi = np.minimum(lo + rng.integers(1, 30, 8), g.length)
            keep = hi > lo
            lo, hi = lo[keep], hi[keep]
            path = sj.PathData.build(aln, src, tgt)
            s_lo, s_hi, t_lo, t_hi, rev, own = sj.map_batch(path, lo, hi)
            got = _pairs_with_owner(s_lo, s_hi, t_lo, t_hi, rev, own)
            want = set()
            for i, (l, h) in enumerate(zip(lo, hi)):
                frags = sm.map_source(aln, src, np.array([l]), np.array([h]), tgt)
                for (sp, tp, rv) in fragments_to_base_pairs(frags):
                    want.add((i, sp, tp, rv))
            assert got == want, (src, tgt)
            count += 1
    assert count > 0


def test_overflow_retry():
    aln = create_random_alignment(seed=1, max_genomes=5, min_segments=10,
                                  max_segments=60, min_segment_length=2,
                                  max_segment_length=6)
    names = aln.genome_names()
    src = [n for n in names if aln.tree.is_leaf(n)][0]
    tgt = names[-1] if names[-1] != src else names[0]
    g = aln.open_genome(src)
    path = sj.PathData.build(aln, src, tgt)
    # one interval covering the whole genome with tiny capacity multiplier
    out = sj.map_batch(path, np.array([0]), np.array([g.length]), cap_mult=1)
    s_lo, s_hi, t_lo, t_hi, rev, own = out
    frags = sm.map_source(aln, src, np.array([0]), np.array([g.length]), tgt)
    got = _pairs_with_owner(s_lo, s_hi, t_lo, t_hi, rev, own)
    want = {(0, a, b, c) for (a, b, c) in fragments_to_base_pairs(frags)}
    assert got == want


def test_paged_lookup_matches_host():
    """The paged segment lookup on small grids gives device==host; also
    sanity-check the page-table builder and the host sizing totals feed
    tight caps without overflow."""
    aln = create_random_alignment(seed=5, max_genomes=5, min_segments=8,
                                  max_segments=40, min_segment_length=3,
                                  max_segment_length=9)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    g = aln.open_genome(src)
    rng = np.random.default_rng(5)
    lo = rng.integers(0, g.length - 2, 16)
    hi = np.minimum(lo + rng.integers(1, 40, 16), g.length)
    path = sj.PathData.build(aln, src, tgt)
    assert any(lv.page_tab is not None for lv in path.levels)
    totals = sj.host_level_totals(aln, src, tgt, lo, hi)
    caps = sj.tight_caps(path, totals)
    import jax.numpy as jnp

    dtype = path.levels[0].grid.dtype
    F, bound, ovf, _ = sj._map_batch_jit(
        path, jnp.asarray(lo, dtype), jnp.asarray(hi, dtype),
        jnp.arange(len(lo), dtype=dtype), caps)
    assert not bool(np.asarray(ovf.reshape(1))[0]), "host sizing undersized"
    Fc, total = sj._compact_jit(F)
    k = int(np.asarray(total.reshape(1))[0])
    M = np.asarray(Fc[:, :k])
    got = _pairs_with_owner(M[0], M[1], M[2], M[3], M[4], M[5])
    want = set()
    for i, (l, h) in enumerate(zip(lo, hi)):
        frags = sm.map_source(aln, src, np.array([l]), np.array([h]), tgt)
        for (sp, tp, rv) in fragments_to_base_pairs(frags):
            want.add((i, sp, tp, rv))
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_option_combos_exhaustive_pairs(seed):
    """Device==host over every ordered genome pair x option combos
    (do_dupes / min_length / coalescence_limit) — VERDICT next #4."""
    aln = create_random_alignment(seed=seed, max_genomes=5, min_genomes=4,
                                  min_segments=3, max_segments=18,
                                  min_segment_length=2, max_segment_length=9)
    names = aln.genome_names()
    rng = np.random.default_rng(seed)
    root = aln.root_name
    checked = 0
    for src in names:
        g = aln.open_genome(src)
        if g.length < 4:
            continue
        lo = rng.integers(0, g.length - 2, 6)
        hi = np.minimum(lo + rng.integers(1, 25, 6), g.length)
        for tgt in names:
            if tgt == src:
                continue
            mrca = aln.tree.lca(src, tgt)
            combos = [dict(do_dupes=True), dict(do_dupes=False),
                      dict(do_dupes=True, min_length=3)]
            if mrca != root:
                combos.append(dict(do_dupes=True, coalescence_limit=root))
            for opts in combos:
                path = sj.PathData.build(aln, src, tgt,
                                         do_dupes=opts.get("do_dupes", True),
                                         coalescence_limit=opts.get("coalescence_limit"),
                                         min_length=opts.get("min_length", 0))
                s_lo, s_hi, t_lo, t_hi, rev, own = sj.map_batch(path, lo, hi)
                got = _pairs_with_owner(s_lo, s_hi, t_lo, t_hi, rev, own)
                want = set()
                for i, (l, h) in enumerate(zip(lo, hi)):
                    frags = sm.map_source(
                        aln, src, np.array([l]), np.array([h]), tgt,
                        do_dupes=opts.get("do_dupes", True),
                        min_length=opts.get("min_length", 0),
                        coalescence_limit=opts.get("coalescence_limit"))
                    for (sp, tp, rv) in fragments_to_base_pairs(frags):
                        want.add((i, sp, tp, rv))
                assert got == want, (src, tgt, opts)
                checked += 1
    assert checked >= 12


def test_uint32_path_big_genome():
    """Genomes past 2^31 bases select the uint32 device dtype (32-bit rows
    halve the bytes each gather moves) — results must equal the host
    oracle, and the packed u32 transfer must be lossless."""
    import jax.numpy as jnp

    aln = create_random_alignment(seed=4, max_genomes=5, min_genomes=4,
                                  min_segments=6, max_segments=14,
                                  min_segment_length=1 << 28,
                                  max_segment_length=(1 << 28) + 64,
                                  store_dna=False)
    names = aln.genome_names()
    leaves = [n for n in names if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], (leaves[-1] if leaves[-1] != leaves[0] else names[0])
    g = aln.open_genome(src)
    assert g.length > 2 ** 31
    rng = np.random.default_rng(0)
    lo = rng.integers(0, g.length - 300, 32)
    hi = lo + rng.integers(1, 200, 32)
    path = sj.PathData.build(aln, src, tgt)
    assert path.levels[0].grid.dtype == jnp.uint32
    s_lo, s_hi, t_lo, t_hi, rev, own = sj.map_batch(path, lo, hi)
    got = _pairs_with_owner(s_lo, s_hi, t_lo, t_hi, rev, own)
    want = set()
    for i, (l, h) in enumerate(zip(lo, hi)):
        frags = sm.map_source(aln, src, np.array([l]), np.array([h]), tgt)
        for (sp, tp, rv) in fragments_to_base_pairs(frags):
            want.add((i, sp, tp, rv))
    assert got == want

    # packed u32 fixed-size compaction round-trips the same rows
    totals, final_rows = sj.host_level_totals(aln, src, tgt, lo, hi,
                                              with_final=True)
    caps = sj.tight_caps(path, totals)
    dt = path.levels[0].grid.dtype
    F, bound, ovf, _ = sj._map_batch_jit(
        path, jnp.asarray(lo, dt), jnp.asarray(hi, dt),
        jnp.arange(len(lo), dtype=dt), caps)
    assert not bool(np.asarray(ovf.reshape(1))[0])
    out_cols = sj._bucket_cap(final_rows)
    out, total, covf = sj._compact_u32_fixed_jit(F, out_cols, 8)
    assert not bool(np.asarray(covf.reshape(1))[0])
    k = int(np.asarray(total.reshape(1))[0])
    assert k == final_rows
    ds_lo, ds_hi, dt_lo, dt_hi, drev, down = sj.decode_u32_fixed(
        np.asarray(out), k, 8)
    got2 = _pairs_with_owner(ds_lo, ds_hi, dt_lo, dt_hi, drev, down)
    assert got2 == want


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64])
@pytest.mark.parametrize("n_grid", [500, 70000])
@pytest.mark.parametrize("paged", [True, False])
def test_searchsorted_dispatch_matches_numpy(dtype, n_grid, paged):
    """_searchsorted_right == np.searchsorted(side="right") through the
    paged lookup and through jnp.searchsorted (a level without a page
    table), on short and long grids, including queries before the grid's
    first and past its last entry."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n_grid)
    top = 40 * n_grid
    grid = np.unique(np.concatenate([[100], rng.integers(100, top, n_grid)]))
    q_min = 0 if dtype == np.uint32 else -50
    q = rng.integers(q_min, top + 200, 4096)
    q[:4] = [q_min, 99, top + 150, grid[-1]]
    page_tab, shift = sj._pages(grid)
    assert page_tab is not None  # every grid here has a page table
    if not paged:
        page_tab, shift = None, 0
    out = sj._searchsorted_right(jnp.asarray(grid, dtype),
                                 jnp.asarray(q, dtype), page_tab, shift)
    assert out.dtype == jnp.dtype(dtype)
    want = np.searchsorted(grid, q, side="right")
    assert np.array_equal(np.asarray(out).astype(np.int64), want)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64])
@pytest.mark.parametrize("full", [False, True])
def test_expand_owner_matches_repeat(dtype, full):
    """own[j] is the input owning output slot j (np.repeat of the input
    indices by their counts), zero counts own nothing, and a cap_out equal
    to the total fills every slot."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    counts = rng.integers(0, 4, 300)
    counts[:5] = 0
    counts[-3:] = 0
    total = int(counts.sum())
    cap = total if full else total + 37
    own, offsets, tot = jax.jit(sj._expand_owner, static_argnums=1)(
        jnp.asarray(counts, dtype), cap)
    assert own.shape == (cap,)
    assert int(tot) == total
    assert np.array_equal(np.asarray(offsets), np.cumsum(counts) - counts)
    want = np.repeat(np.arange(len(counts)), counts)
    assert np.array_equal(np.asarray(own)[:total], want)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, places the cache and the code
    sets no directory; unset, the cache is the fixed <repo>/.jax_cache."""
    import os

    calls = {}
    monkeypatch.setattr(sj.jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    sj.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == os.path.join(
            repo, ".jax_cache")
    assert "jax_persistent_cache_min_compile_time_secs" in calls
