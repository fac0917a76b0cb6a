"""Python-free native blockViz server (native/blockviz_server.cpp) vs the
Python engine (hal_tpu.blockviz): block-list equality across dup/seq/
adjacency/reversed modes, plus species/chroms/dna accessors and lod.txt."""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from hal_tpu.native import library_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(REPO, "native", "libhalblockviz_native.so")


@pytest.fixture(autouse=True, scope="module")
def _built_lib():
    if library_path("libhalblockviz_native.so") is None:
        pytest.skip("libhalblockviz_native.so cannot be built")


class _Block(ctypes.Structure):
    pass


_Block._fields_ = [("next", ctypes.POINTER(_Block)),
                   ("qChrom", ctypes.c_char_p),
                   ("tStart", ctypes.c_int64), ("qStart", ctypes.c_int64),
                   ("size", ctypes.c_int64), ("strand", ctypes.c_char),
                   ("qSequence", ctypes.c_char_p),
                   ("tSequence", ctypes.c_char_p)]


class _TRange(ctypes.Structure):
    pass


_TRange._fields_ = [("next", ctypes.POINTER(_TRange)),
                    ("tStart", ctypes.c_int64), ("size", ctypes.c_int64)]


class _Dupe(ctypes.Structure):
    pass


_Dupe._fields_ = [("next", ctypes.POINTER(_Dupe)), ("id", ctypes.c_int64),
                  ("tRange", ctypes.POINTER(_TRange)),
                  ("qChrom", ctypes.c_char_p)]


class _Results(ctypes.Structure):
    _fields_ = [("mappedBlocks", ctypes.POINTER(_Block)),
                ("targetDupeBlocks", ctypes.POINTER(_Dupe))]


def _load():
    lib = ctypes.CDLL(LIB)
    lib.halOpen.restype = ctypes.c_int
    lib.halOpen.argtypes = [ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_char_p)]
    lib.halGetBlocksInTargetRange.restype = ctypes.POINTER(_Results)
    lib.halGetBlocksInTargetRange.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p)]
    lib.halFreeBlockResults.restype = None
    lib.halFreeBlockResults.argtypes = [ctypes.POINTER(_Results)]
    lib.halGetDna.restype = ctypes.c_void_p
    return lib


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    from hal_tpu.randgen import create_random_alignment
    from hal_tpu.storage import save_alignment

    d = tmp_path_factory.mktemp("bvn")
    aln = create_random_alignment(seed=9, max_genomes=7, min_genomes=5,
                                  mean_degree=1.5, max_branch_length=0.6,
                                  min_segment_length=4, max_segment_length=20,
                                  min_segments=10, max_segments=60)
    path = str(d / "t.halz")
    save_alignment(aln, path, fmt="halz")
    return aln, path


def _native_blocks(lib, h, q, t, chrom, lo, hi, seq=0, dup=1, adj=0, rev=0):
    err = ctypes.c_char_p()
    r = lib.halGetBlocksInTargetRange(h, q.encode(), t.encode(),
                                      chrom.encode(), lo, hi, rev, seq, dup,
                                      adj, None, ctypes.byref(err))
    assert r, err.value
    out = []
    b = r.contents.mappedBlocks
    while b:
        bb = b.contents
        out.append((bb.qChrom.decode(), bb.tStart, bb.qStart, bb.size,
                    bb.strand.decode(),
                    bb.qSequence.decode() if bb.qSequence else None,
                    bb.tSequence.decode() if bb.tSequence else None))
        b = bb.next
    dupes = []
    dl = r.contents.targetDupeBlocks
    while dl:
        dd = dl.contents
        ranges = []
        tr = dd.tRange
        while tr:
            ranges.append((tr.contents.tStart, tr.contents.size))
            tr = tr.contents.next
        dupes.append((dd.qChrom.decode(), ranges))
        dl = dd.next
    lib.halFreeBlockResults(r)
    return out, dupes


def _python_blocks(aln, q, t, chrom, lo, hi, seq=0, dup=1, adj=0, rev=0):
    from hal_tpu import blockviz as bv

    class H:
        lod = None
        def alignment(self, qlen=0, force_lod0=False):
            return aln

    blocks, dupes = bv.get_blocks_in_target_range(
        H(), q, t, chrom, lo, hi, seq_mode=seq, dup_mode=dup,
        map_back_adjacencies=bool(adj), t_reversed=bool(rev))
    out = [(b.q_chrom, b.t_start, b.q_start, b.size, b.strand,
            b.q_sequence, b.t_sequence) for b in blocks]
    dl = [(d.q_chrom, [(a, b - a) for (a, b) in d.t_ranges]) for d in dupes]
    return out, dl


def test_native_blocks_match_python(fixture):
    aln, path = fixture
    lib = _load()
    err = ctypes.c_char_p()
    h = lib.halOpen(path.encode(), ctypes.byref(err))
    assert h >= 0, err.value
    leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 0]
    t, q = leaves[0], leaves[-1]
    tg = aln.open_genome(t)
    chrom = tg.seq_names[0]
    clen = int(tg.seq_start[1] - tg.seq_start[0])
    cases = [dict(seq=0, dup=1), dict(seq=1, dup=1), dict(seq=1, dup=0),
             dict(seq=1, dup=1, adj=1), dict(seq=1, dup=2),
             dict(seq=0, dup=1, rev=1)]
    rng = np.random.default_rng(4)
    for case in cases:
        for _ in range(6):
            lo = int(rng.integers(0, max(clen - 8, 1)))
            hi = min(lo + int(rng.integers(4, 40)), clen)
            nat = _native_blocks(lib, h, q, t, chrom, lo, hi, **case)
            py = _python_blocks(aln, q, t, chrom, lo, hi, **case)
            assert nat == py, (case, lo, hi, nat, py)


def test_native_lod_manifest_and_dna(fixture, tmp_path):
    aln, path = fixture
    lodtxt = tmp_path / "lod.txt"
    r = subprocess.run([sys.executable, "-m",
                        "hal_tpu.tools.halLodInterpolate", path, str(lodtxt),
                        "--outHalDir", str(tmp_path), "--maxBlock", "8"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = _load()
    err = ctypes.c_char_p()
    h = lib.halOpen(str(lodtxt).encode(), ctypes.byref(err))
    assert h >= 0, err.value
    leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 0]
    t, q = leaves[0], leaves[-1]
    tg = aln.open_genome(t)
    chrom = tg.seq_names[0]
    # a tiny query is served by LOD0 -> identical to the direct alignment
    nat, _ = _native_blocks(lib, h, q, t, chrom, 0,
                            min(8, int(tg.seq_start[1])), seq=1)
    py, _ = _python_blocks(aln, q, t, chrom, 0, min(8, int(tg.seq_start[1])),
                           seq=1)
    assert nat == py
    # dna accessor equals the python codec
    p = lib.halGetDna(h, t.encode(), chrom.encode(), 0, 10,
                      ctypes.byref(err))
    assert p, err.value
    s = ctypes.string_at(p).decode()
    assert s == tg.get_dna_string(int(tg.seq_start[0]), 10)


def test_bad_handle_reports_error_not_ub(fixture):
    """Accessors must validate the handle (a failed halOpen returns -1;
    browser servers may also pass stale handles) instead of indexing
    g_handles out of bounds."""
    lib = _load()
    lib.halGetSpecies.restype = ctypes.c_void_p
    lib.halGetSpecies.argtypes = [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_char_p)]
    for bad in (-1, 9999):
        err = ctypes.c_char_p()
        assert lib.halGetSpecies(bad, ctypes.byref(err)) is None
        assert err.value == b"bad handle"
        err = ctypes.c_char_p()
        assert lib.halGetDna(bad, b"x", b"y", 0, 1, ctypes.byref(err)) is None
        assert err.value == b"bad handle"


def test_seq_names_scoped_to_genome_object(fixture, tmp_path):
    """A genome name that also appears EARLIER in the manifest (here: as
    an alignment metadata value, which halz serializes before the genomes
    map) must not capture another genome's seq_names list."""
    import shutil

    aln, path = fixture
    leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 0]
    victim = leaves[-1]
    d = str(tmp_path / "meta.halz")
    shutil.copytree(path, d)
    import json

    with open(os.path.join(d, "halz.json")) as fh:
        man = json.load(fh)
    assert list(man).index("metadata") < list(man).index("genomes")
    man["metadata"] = {"refGenome": victim}
    with open(os.path.join(d, "halz.json"), "w") as fh:
        json.dump(man, fh, indent=1)
    lib = _load()
    lib.halGetChroms.restype = ctypes.c_void_p
    lib.halGetChroms.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_char_p)]
    err = ctypes.c_char_p()
    h = lib.halOpen(d.encode(), ctypes.byref(err))
    assert h >= 0, err.value
    p = lib.halGetChroms(h, victim.encode(), ctypes.byref(err))
    assert p, err.value

    class _Chrom(ctypes.Structure):
        pass

    _Chrom._fields_ = [("next", ctypes.POINTER(_Chrom)),
                       ("name", ctypes.c_char_p),
                       ("length", ctypes.c_int64)]
    got = []
    node = ctypes.cast(p, ctypes.POINTER(_Chrom))
    while node:
        got.append(node.contents.name.decode())
        node = node.contents.next
    assert got == list(aln.open_genome(victim).seq_names)
