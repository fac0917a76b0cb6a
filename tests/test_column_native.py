"""Native C++ column engine (native/column_engine.cpp) vs the pure-Python
exact path: byte equality of the full MAF text across flag combinations.
The Python path is the oracle (it matches every reference hal2maf golden,
tests/test_reference_goldens.py)."""

import pytest

from hal_tpu.io.maf_io import MafBlockBuilder
from hal_tpu.ops import column_native as cn
from hal_tpu.ops.column import compute_scope, iter_slices_exact

from fixtures import three_genome_alignment


@pytest.fixture(autouse=True, scope="module")
def _built_lib():
    if not cn.available():
        pytest.skip("libhalcolumn.so cannot be built")


def _python_maf(aln, ref, gs, ge, window=1 << 20, **kw):
    builder = MafBlockBuilder(aln, ref, max_block_len=kw.pop("max_block_len", 1000),
                              ucsc_names=kw.pop("ucsc_names", True))
    out = []
    pos = gs
    while pos < ge:
        end = min(pos + window, ge)
        for block in builder.feed(iter_slices_exact(aln, ref, pos, end, **kw)):
            out.append(block + "\n")
        pos = end
    b = builder.flush_end()
    if b:
        out.append(b + "\n")
    return "".join(out).encode()


def _native_maf(aln, ref, gs, ge, window=1 << 20, scope=None, targets=None,
                no_dupes=False, no_ancestors=False, only_orthologs=False,
                unique=False, max_block_len=1000, ucsc_names=True):
    ex = cn.NativeMafExporter(aln, ref, scope=scope, targets=targets,
                              no_dupes=no_dupes, no_ancestors=no_ancestors,
                              only_orthologs=only_orthologs, unique=unique,
                              max_block_len=max_block_len,
                              ucsc_names=ucsc_names)
    out = []
    pos = gs
    while pos < ge:
        end = min(pos + window, ge)
        out.append(ex.export(pos, end))
        pos = end
    out.append(ex.finish())
    ex.close()
    return b"".join(out)


def _assert_equal(aln, ref, gs, ge, **kw):
    py = _python_maf(aln, ref, gs, ge, **kw)
    nat = _native_maf(aln, ref, gs, ge, **kw)
    assert nat == py


def test_three_genome_all_refs():
    aln = three_genome_alignment()
    for ref in ("Anc", "A", "B"):
        ge = aln.open_genome(ref).length
        _assert_equal(aln, ref, 0, ge)


def test_three_genome_flags():
    aln = three_genome_alignment()
    _assert_equal(aln, "A", 0, 25, no_dupes=True)
    _assert_equal(aln, "A", 0, 25, no_ancestors=True)
    _assert_equal(aln, "B", 0, 25, only_orthologs=True)
    _assert_equal(aln, "B", 0, 25, unique=True)
    _assert_equal(aln, "Anc", 0, 30, unique=True)
    _assert_equal(aln, "A", 0, 25, ucsc_names=False)
    _assert_equal(aln, "A", 3, 21)


def test_three_genome_scope_targets():
    aln = three_genome_alignment()
    scope, _root = compute_scope(aln, "A", targets=["B"])
    _assert_equal(aln, "A", 0, 25, scope=scope, targets={"A", "B"})


def test_max_block_len_and_windows():
    aln = three_genome_alignment()
    _assert_equal(aln, "A", 0, 25, max_block_len=3)
    # window chunking must not change bytes (block state carries over)
    full = _native_maf(aln, "A", 0, 25)
    chunked = _native_maf(aln, "A", 0, 25, window=7)
    assert chunked == full


@pytest.mark.parametrize("seed", [21, 5, 9])
def test_random_alignments(seed):
    from hal_tpu.randgen import create_random_alignment

    aln = create_random_alignment(seed=seed, max_genomes=7, min_genomes=4,
                                  mean_degree=1.3, max_branch_length=0.6,
                                  min_segment_length=3, max_segment_length=12,
                                  min_segments=6, max_segments=40)
    names = sorted(aln.genome_names())
    leaves = [n for n in names if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 0]
    for ref in [aln.root_name] + leaves[:2]:
        ge = aln.open_genome(ref).length
        if ge == 0:
            continue
        _assert_equal(aln, ref, 0, ge, window=13)
        _assert_equal(aln, ref, 0, ge, unique=True)
        _assert_equal(aln, ref, 0, ge, no_dupes=True, max_block_len=5)
        _assert_equal(aln, ref, 0, ge, no_ancestors=True)


def test_random_scope_and_targets():
    from hal_tpu.randgen import create_random_alignment

    aln = create_random_alignment(seed=33, max_genomes=8, min_genomes=5,
                                  mean_degree=1.6, max_branch_length=0.5,
                                  min_segment_length=4, max_segment_length=9,
                                  min_segments=8, max_segments=30)
    leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 0]
    if len(leaves) < 2:
        pytest.skip("fixture too small")
    ref, other = leaves[0], leaves[-1]
    targets = {ref, other}
    scope = aln.tree.spanning_tree(sorted(targets))
    ge = aln.open_genome(ref).length
    _assert_equal(aln, ref, 0, ge, scope=scope, targets=targets)
    _assert_equal(aln, ref, 0, ge, scope=scope, targets=targets,
                  only_orthologs=True)


def test_maybe_native_exporter_gates():
    aln = three_genome_alignment()
    # r5: maxRefGap and --global are now native; printTree still gates
    assert cn.maybe_native_exporter(aln, "A", max_ref_gap=5) is not None
    assert cn.maybe_native_exporter(aln, "A", print_tree=True) is None
    assert cn.maybe_native_exporter(aln, "A", shared_visit={}) is not None
    assert cn.maybe_native_exporter(aln, "A") is not None
    # DNA-less genomes cannot take the native path
    from hal_tpu.randgen import create_random_alignment

    bare = create_random_alignment(seed=3, max_genomes=4, min_genomes=3,
                                   min_segments=4, max_segments=8,
                                   store_dna=False)
    assert cn.maybe_native_exporter(bare, bare.root_name) is None


def test_multi_sequence_genomes():
    """Genomes with several sequences: sequence-boundary run clamps,
    per-sequence entry keys, and ref-sequence selection must match."""
    import numpy as np

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
        ge = aln.open_genome(ref).length
        _assert_equal(aln, ref, 0, ge)
        _assert_equal(aln, ref, 0, ge, max_block_len=3)
        _assert_equal(aln, ref, 2, ge - 3, unique=True)


def test_native_max_ref_gap_parity():
    """Native indel stacks (--maxRefGap) == Python exact path, byte-equal
    (VERDICT r4 missing #4: the 50x flag cliff)."""
    from hal_tpu.randgen import create_random_alignment
    from hal_tpu.io.maf_io import MafBlockBuilder
    from hal_tpu.ops.column_native import NativeMafExporter, available

    if not available():
        pytest.skip("native column engine not built")
    for seed in (11, 42, 77):
        aln = create_random_alignment(seed=seed, max_genomes=7,
                                      min_genomes=5, min_segments=6,
                                      max_segments=30, min_segment_length=3,
                                      max_segment_length=12)
        leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
        for ref in (leaves[0], leaves[-1]):
            ge = int(aln.open_genome(ref).length)
            for gap in (5, 20):
                b = MafBlockBuilder(aln, ref, ucsc_names=True,
                                    keep_empty_ref_blocks=False)
                blocks = list(b.feed(iter_slices_exact(
                    aln, ref, 0, ge, max_ref_gap=gap)))
                t = b.flush_end()
                if t:
                    blocks.append(t)
                want = ("\n".join(blocks) + "\n").encode() if blocks else b""
                ex = NativeMafExporter(aln, ref, max_ref_gap=gap,
                                       keep_empty_ref_blocks=False)
                got = ex.export(0, ge) + ex.finish()
                ex.close()
                assert got == want, (seed, ref, gap)


def test_native_global_parity():
    """Native --global (shared visit cache across per-leaf passes) ==
    Python exact path, byte-equal."""
    from hal_tpu.randgen import create_random_alignment
    from hal_tpu.io.maf_io import MafBlockBuilder
    from hal_tpu.ops.column_native import NativeMafExporter, available

    if not available():
        pytest.skip("native column engine not built")
    for seed in (11, 42, 104):
        aln = create_random_alignment(seed=seed, max_genomes=7,
                                      min_genomes=5, min_segments=6,
                                      max_segments=30, min_segment_length=3,
                                      max_segment_length=12)
        leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
        out = []
        visited = {}
        for ref in leaves:
            g = aln.open_genome(ref)
            b = MafBlockBuilder(aln, ref, ucsc_names=True)
            out.extend(b.feed(iter_slices_exact(aln, ref, 0, g.length,
                                                shared_visit=visited)))
            t = b.flush_end()
            if t:
                out.append(t)
        want = ("\n".join(out) + "\n").encode() if out else b""
        ex = NativeMafExporter(aln, leaves[0], global_mode=True)
        got = b""
        for ref in leaves:
            ex.set_ref(ref)
            g = aln.open_genome(ref)
            got += ex.export(0, int(g.length))
            got += ex.finish()
        ex.close()
        assert got == want, seed
