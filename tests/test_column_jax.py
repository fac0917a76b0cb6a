"""Device column engine (hal_tpu.ops.column_jax) — the device 'iterative
frontier scan' equivalent of the reference ColumnIterator
(/root/reference/api/impl/halColumnIterator.cpp:246-356 feeding
maf/impl/halMafExport.cpp:25-89).

The contract is BYTE equality of the assembled MAF against the exact-DFS
engine (hal_tpu.ops.column.iter_slices_exact), which itself reproduces
the reference goldens — including duplicate-row insertion order under
paralogy, reconstructed from per-fragment DFS keys."""

import numpy as np
import pytest

from hal_tpu.randgen import create_random_alignment
from hal_tpu.io.maf_io import MafBlockBuilder
from hal_tpu.ops.column import iter_slices_exact
from hal_tpu.ops.column_jax import (ColumnHostSim, DeviceColumnEngine,
                                    build_programs, iter_slices_hostsim)


def _export(aln, ref, slices, **kw):
    b = MafBlockBuilder(aln, ref, ucsc_names=True, **kw)
    blocks = list(b.feed(slices))
    t = b.flush_end()
    if t:
        blocks.append(t)
    return "\n".join(blocks)


def _aln(seed, **kw):
    args = dict(seed=seed, max_genomes=7, min_genomes=5, min_segments=6,
                max_segments=30, min_segment_length=3, max_segment_length=12)
    args.update(kw)
    return create_random_alignment(**args)


@pytest.mark.parametrize("seed", [3, 11, 21, 42, 77])
def test_hostsim_byte_equal_exact(seed):
    """Host twin == exact DFS MAF, leaf + internal + root references,
    paralogy rings present in every seed."""
    aln = _aln(seed)
    n_para = sum(int((aln.open_genome(n).top_paralogy >= 0).sum())
                 for n in aln.genome_names()
                 if aln.open_genome(n).top_paralogy.size)
    assert n_para > 0, "fixture must exercise duplicate-row ordering"
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    for ref in (leaves[0], leaves[-1], aln.root_name):
        g = aln.open_genome(ref)
        if g.length == 0:
            continue
        ge = int(g.length)
        want = _export(aln, ref, iter_slices_exact(aln, ref, 0, ge))
        got = _export(aln, ref, iter_slices_hostsim(aln, ref, 0, ge))
        assert got == want, (seed, ref)


@pytest.mark.parametrize("seed", [11, 42])
def test_device_engine_byte_equal_exact(seed):
    aln = _aln(seed)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    for ref in (leaves[0], aln.root_name):
        g = aln.open_genome(ref)
        if g.length == 0:
            continue
        ge = int(g.length)
        want = _export(aln, ref, iter_slices_exact(aln, ref, 0, ge))
        eng = DeviceColumnEngine(aln, ref)
        got = _export(aln, ref, eng.window_slices(0, ge))
        assert got == want, (seed, ref)


def test_device_engine_windowed_matches_single_window():
    """Chunked windows through ONE persistent builder equal the
    single-window export (hal2maf streams windows the same way)."""
    aln = _aln(21)
    ref = [n for n in aln.genome_names() if aln.tree.is_leaf(n)][0]
    ge = int(aln.open_genome(ref).length)
    want = _export(aln, ref, iter_slices_exact(aln, ref, 0, ge))
    eng = DeviceColumnEngine(aln, ref)
    b = MafBlockBuilder(aln, ref, ucsc_names=True)
    blocks = []
    W = max(ge // 3, 1)
    pos = 0
    while pos < ge:
        end = min(pos + W, ge)
        blocks.extend(b.feed(eng.window_slices(pos, end)))
        pos = end
    t = b.flush_end()
    if t:
        blocks.append(t)
    assert "\n".join(blocks) == want


def test_device_engine_filters():
    """noAncestors and target filtering are output-side filters."""
    aln = _aln(77)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    ref = leaves[0]
    ge = int(aln.open_genome(ref).length)
    want = _export(aln, ref, iter_slices_exact(aln, ref, 0, ge,
                                               no_ancestors=True))
    eng = DeviceColumnEngine(aln, ref, no_ancestors=True)
    assert _export(aln, ref, eng.window_slices(0, ge)) == want

    targets = set(leaves[:2]) | {ref}
    scope = aln.tree.spanning_tree(sorted(targets))
    want = _export(aln, ref, iter_slices_exact(aln, ref, 0, ge,
                                               scope=scope, targets=targets))
    eng = DeviceColumnEngine(aln, ref, scope=scope, targets=targets)
    assert _export(aln, ref, eng.window_slices(0, ge)) == want


def test_program_enumeration_shape():
    """MAIN ordinal placement: first for on-chain targets (the reference
    genome inserts its primary row before any branch), last for off-chain
    targets (canonical descent is the final recursion stage)."""
    aln = _aln(11)
    from hal_tpu.ops.column import compute_scope

    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    ref = leaves[0]
    scope, root = compute_scope(aln, ref)
    progs = build_programs(aln, ref, scope, root)
    assert set(progs) == set(scope)
    # ref's main program is the empty (identity) program at ordinal 0
    mains = [s for s in progs[ref] if not s.ops]
    assert len(mains) == 1 and mains[0].ordinal == 0
    # every other program of ref ends at ref
    chain_nodes = set()
    n = ref
    while n is not None:
        chain_nodes.add(n)
        n = aln.tree.parent(n)
    for t, specs in progs.items():
        on_chain = t in chain_nodes
        main = [s for s in specs
                if not any(op[0] == "selfring" for op in s.ops)]
        assert len(main) == 1
        if on_chain:
            assert main[0].ordinal == 0
        else:
            assert main[0].ordinal == len(specs) - 1
        # branch ordinals are by descending coalescence height: deeper
        # branches (more up-hops) come first
        branches = [s for s in specs
                    if any(op[0] == "selfring" for op in s.ops)]
        ups = [sum(1 for op in s.ops if op[0] == "up") for s in
               sorted(branches, key=lambda s: s.ordinal)]
        assert ups == sorted(ups, reverse=True)


def test_key_space_guard():
    """key_space reports the radix product the dtype check guards."""
    aln = _aln(3)
    from hal_tpu.ops.column import compute_scope

    ref = [n for n in aln.genome_names() if aln.tree.is_leaf(n)][0]
    scope, root = compute_scope(aln, ref)
    sim = ColumnHostSim(aln)
    for specs in build_programs(aln, ref, scope, root).values():
        for s in specs:
            assert sim.key_space(s) >= 1


def test_native_assembler_byte_equal():
    """Device fragments -> native C++ assembler (ce_export_frags) equals
    the native DFS engine's bytes (which equal the reference goldens)."""
    from hal_tpu.ops.column_native import NativeMafExporter, available

    if not available():
        pytest.skip("native column engine not built")
    for seed in (11, 77):
        aln = _aln(seed)
        leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
        for ref in (leaves[0], aln.root_name):
            g = aln.open_genome(ref)
            if g.length == 0:
                continue
            ge = int(g.length)
            ex1 = NativeMafExporter(aln, ref)
            want = ex1.export(0, ge) + ex1.finish()
            ex1.close()
            eng = DeviceColumnEngine(aln, ref)
            ex2 = NativeMafExporter(aln, ref)
            # two windows through one exporter: block state must persist
            mid = ge // 2
            got = eng.export_native(ex2, 0, mid)
            got += eng.export_native(ex2, mid, ge)
            got += ex2.finish()
            ex2.close()
            assert got == want, (seed, ref)


def test_device_engine_nodupes_onlyorthologs():
    """--noDupes (canonical-gated up levels, ringless downs) and
    --onlyOrthologs (branches dropped, destination rings kept) on the
    device engine, byte-equal to the exact DFS."""
    for seed in (11, 77):
        aln = _aln(seed)
        leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
        for ref in (leaves[0], aln.root_name):
            g = aln.open_genome(ref)
            if g.length == 0:
                continue
            ge = int(g.length)
            want = _export(aln, ref, iter_slices_exact(aln, ref, 0, ge,
                                                       no_dupes=True))
            eng = DeviceColumnEngine(aln, ref, no_dupes=True)
            assert _export(aln, ref, eng.window_slices(0, ge)) == want, \
                ("noDupes", seed, ref)
            want = _export(aln, ref, iter_slices_exact(
                aln, ref, 0, ge, only_orthologs=True))
            eng = DeviceColumnEngine(aln, ref, only_orthologs=True)
            assert _export(aln, ref, eng.window_slices(0, ge)) == want, \
                ("onlyOrthologs", seed, ref)


def test_device_engine_multi_sequence():
    """Genomes with several sequences: per-sequence entry keys, sequence
    boundary cuts and ref-sequence selection through the device engine."""
    from hal_tpu.alignment import Alignment
    from hal_tpu.genome import GenomeArrays, SequenceInfo
    from hal_tpu.ops.validate import validate_alignment

    aln = Alignment()
    aln.add_root_genome("Anc", [SequenceInfo("sA", 12, 0, 3),
                                SequenceInfo("sB", 8, 0, 2)])
    aln.tree.add_child("Anc", "X", 0.1)
    anc = aln.open_genome("Anc")
    anc.bot_start[:-1] = [0, 4, 8, 12, 16]
    anc.bot_child = np.array([[0], [1], [3], [2], [4]], np.int64)
    anc.bot_child_reversed = np.array([[0], [0], [1], [0], [0]], np.uint8)
    x = GenomeArrays.create("X", [SequenceInfo("x1", 12, 3, 0),
                                  SequenceInfo("x2", 8, 2, 0)],
                            num_children=0)
    x.top_start[:-1] = [0, 4, 8, 12, 16]
    x.top_parent = np.array([0, 1, 3, 2, 4], np.int64)
    x.top_parent_reversed = np.array([0, 0, 0, 1, 0], np.uint8)
    aln.set_genome(x)
    rng = np.random.default_rng(1)
    DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
    anc.set_dna(0, DNA[rng.integers(0, 4, 20)])
    out = np.empty(20, np.uint8)
    for i in range(5):
        p = int(x.top_parent[i])
        out[i * 4:(i + 1) * 4] = anc.get_dna(
            p * 4, 4, reversed_=bool(x.top_parent_reversed[i]))
    x.set_dna(0, out)
    validate_alignment(aln)
    for ref in ("Anc", "X"):
        ge = int(aln.open_genome(ref).length)
        want = _export(aln, ref, iter_slices_exact(aln, ref, 0, ge))
        eng = DeviceColumnEngine(aln, ref)
        assert _export(aln, ref, eng.window_slices(0, ge)) == want, ref
        want3 = _export(aln, ref, iter_slices_exact(aln, ref, 0, ge),
                        max_block_len=3)
        assert _export(aln, ref, eng.window_slices(0, ge),
                       max_block_len=3) == want3, ref
