"""Byte-equality tests against the reference's shipped golden outputs.

These are the only ground-truth artifacts available without building the
reference: expected tool outputs checked into /root/reference/*/tests/expected
plus two binary alignment fixtures (paf/tests/input/mr.hal — a real
cactus-produced HDF5 mouse/rat alignment — and
extract/tests/input/small.mmap1.0.hal.bz2 — a legacy mmap-format file).
Each test runs one of our CLI tools and diffs stdout/file output
byte-for-byte against the golden (reference paf/Makefile:20-31,
liftover/Makefile:32-70, maf/Makefile:40-56, synteny/Makefile:23-25).
"""

import bz2
import gzip
import io
import os
import subprocess
import sys

import pytest

REF = "/root/reference"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference checkout not available"
)


def run_tool(args, stdout_path=None):
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        [sys.executable, "-m"] + args,
        cwd=REPO,
        env=env,
        capture_output=True,
        timeout=900,
    )
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    return res.stdout


@pytest.fixture(scope="module")
def small_mmap10(tmp_path_factory):
    out = tmp_path_factory.mktemp("fixtures") / "small.mmap1.0.hal"
    with bz2.open(REF + "/extract/tests/input/small.mmap1.0.hal.bz2") as f:
        out.write_bytes(f.read())
    return str(out)


def _golden(path):
    if path.endswith(".gz"):
        with gzip.open(path) as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def small_hal(tmp_path_factory):
    """halRandGen --preset small --seed 0 --testRand equivalent — the
    fixture every liftover/maf golden was generated from
    (liftover/Makefile:66-68).  Our generator replicates the reference's
    mt19937 stream and random model bit-exactly (hal_tpu.randgen_exact)."""
    from hal_tpu.randgen_exact import create_preset_alignment_exact
    from hal_tpu.storage import hdf5_driver

    out = tmp_path_factory.mktemp("fixtures") / "small.hal"
    aln = create_preset_alignment_exact("small", 0)
    hdf5_driver.save(aln, str(out))
    return str(out)


LIFTOVER_CASES = [
    ("halLiftoverBed3Test.bed", "test1.bed3", []),
    ("halLiftoverBed12Test.bed", "test1.bed12", []),
    ("halLiftoverBed12ExtraTest.bed", "test1.bed12+2", []),
    ("halLiftoverBed4ExtraTest.bed", "test1.bed4+2", ["--bedType", "4"]),
    ("halLiftoverPsl3Test.psl", "test1.bed3", ["--outPSL"]),
    ("halLiftoverPsl12Test.psl", "test1.bed12", ["--outPSL"]),
]


@pytest.mark.parametrize("golden,bed,flags", LIFTOVER_CASES,
                         ids=[c[0] for c in LIFTOVER_CASES])
def test_halLiftover_goldens(small_hal, tmp_path, golden, bed, flags):
    """halLiftover Genome_0 -> Genome_2 vs liftover/tests/expected
    (liftover/Makefile:32-64)."""
    out = tmp_path / "out"
    run_tool(["hal_tpu.tools.halLiftover"] + flags +
             [small_hal, "Genome_0", REF + "/liftover/tests/input/" + bed,
              "Genome_2", str(out)])
    assert out.read_bytes() == _golden(REF + "/liftover/tests/expected/" + golden)


@pytest.mark.parametrize("golden,bed,flags", LIFTOVER_CASES[:4],
                         ids=[c[0] + "-batched" for c in LIFTOVER_CASES[:4]])
def test_halLiftover_goldens_batched(small_hal, tmp_path, golden, bed, flags):
    """--batchSize routes through the bulk mapper (the device kernel when
    JAX has an accelerator); output bytes must be identical (VERDICT next #3)."""
    out = tmp_path / "out"
    run_tool(["hal_tpu.tools.halLiftover", "--batchSize", "512"] + flags +
             [small_hal, "Genome_0", REF + "/liftover/tests/input/" + bed,
              "Genome_2", str(out)])
    assert out.read_bytes() == _golden(REF + "/liftover/tests/expected/" + golden)


MAF_CASES = [
    ("hal2mafSmallTest.maf", []),
    ("hal2mafSeqTest.maf", ["--refGenome", "Genome_2", "--refSequence",
                            "Genome_2_seq", "--unique"]),
    ("hal2mafSeqPartTest.maf", ["--refGenome", "Genome_2", "--refSequence",
                                "Genome_2_seq", "--start", "1000",
                                "--length", "2000"]),
]


@pytest.mark.parametrize("golden,flags", MAF_CASES, ids=[c[0] for c in MAF_CASES])
def test_hal2maf_goldens(small_hal, tmp_path, golden, flags):
    """hal2maf vs maf/tests/expected (maf/Makefile:40-56)."""
    out = tmp_path / "out.maf"
    run_tool(["hal_tpu.tools.hal2maf"] + [small_hal, str(out)] + flags)
    assert out.read_bytes() == _golden(REF + "/maf/tests/expected/" + golden)


def test_hal2maf_global_unique_coverage(small_hal, tmp_path):
    """--global must emit every leaf base exactly once across the whole
    output (convertEntireAlignment's shared visit cache,
    maf/impl/halMafExport.cpp:90-160)."""
    from hal_tpu.storage import open_alignment

    out = tmp_path / "g.maf"
    run_tool(["hal_tpu.tools.hal2maf", "--global", small_hal, str(out)])
    seen = {}
    for line in out.read_text().splitlines():
        if not line.startswith("s\t"):
            continue
        _, src, start, size, strand, srclen, _ = line.split("\t")
        gname = src.split(".")[0]
        start, size, srclen = int(start), int(size), int(srclen)
        if strand == "-":
            start = srclen - start - size
        iv = seen.setdefault(src, set())
        rng = set(range(start, start + size))
        assert not (iv & rng), f"duplicate positions in {src}"
        iv |= rng
    aln = open_alignment(small_hal)
    for name in aln.genome_names():
        if not aln.tree.is_leaf(name):
            continue
        g = aln.open_genome(name)
        total = sum(len(v) for s, v in seen.items()
                    if s.split(".")[0] == name)
        assert total == g.length, f"{name}: {total} != {g.length}"


def test_hal2mafMP_by_sequence(small_hal, tmp_path):
    """hal2mafMP.py --sliceSize=250 --splitBySequence (maf/Makefile:64-66)."""
    out = tmp_path / "t.maf"
    run_tool(["hal_tpu.tools.hal2mafMP", "--sliceSize=250",
              "--splitBySequence", small_hal, str(out)])
    got = (tmp_path / "t_Genome_0_seq.maf").read_bytes()
    assert got == _golden(REF + "/maf/tests/expected/hal2mafMPBySeqTest_Genome_0_seq.maf")


def test_hal2mafMP_target_genomes(small_hal, tmp_path):
    out = tmp_path / "t.maf"
    run_tool(["hal_tpu.tools.hal2mafMP", "--refGenome", "Genome_3",
              "--targetGenomes", "Genome_1,Genome_2", small_hal, str(out)])
    assert out.read_bytes() == _golden(
        REF + "/maf/tests/expected/hal2mafMPTargetGenomesTest.maf")


def test_hal2mafMP_ref_targets(small_hal, tmp_path):
    out = tmp_path / "t.maf"
    run_tool(["hal_tpu.tools.hal2mafMP", "--refTargets",
              REF + "/maf/tests/input/small-Genome_0.bed", small_hal, str(out)])
    assert out.read_bytes() == _golden(
        REF + "/maf/tests/expected/hal2mafMPRefTargetsGenomesTest.maf")


def test_halSynteny_golden(tmp_path):
    """halSynteny Genome_14->Genome_18 on the medium-preset fixture
    (synteny/Makefile:23-29, default preset = medium)."""
    from hal_tpu.randgen_exact import create_preset_alignment_exact
    from hal_tpu.storage import hdf5_driver

    hal = tmp_path / "rand1.hal"
    hdf5_driver.save(create_preset_alignment_exact("medium", 0), str(hal))
    out = tmp_path / "test1.psl"
    run_tool(["hal_tpu.tools.halSynteny", "--queryGenome", "Genome_14",
              "--targetGenome", "Genome_18", str(hal), str(out)])
    assert out.read_bytes() == _golden(REF + "/synteny/tests/expected/test1.psl")


def test_blockViz_golden(tmp_path):
    """blockVizTest --verbose --doSeq on the small preset with
    3000-5000bp segments (blockViz/Makefile:52-67)."""
    from hal_tpu.randgen_exact import create_preset_alignment_exact
    from hal_tpu.storage import hdf5_driver

    hal = tmp_path / "small_bv.hal"
    hdf5_driver.save(create_preset_alignment_exact(
        "small", 0, min_segment_length=3000, max_segment_length=5000), str(hal))
    got = run_tool(["hal_tpu.tools.blockVizTest", "--verbose", "--doSeq",
                    str(hal), "Genome_2", "Genome_0", "Genome_0_seq", "0", "3000"])
    assert got == _golden(REF + "/blockViz/tests/expected/blockVizHdf5Tests.out")
    assert got == _golden(REF + "/blockViz/tests/expected/blockVizMmapTests.out")


def test_hal2paf_small_mmap10(small_mmap10):
    """hal2paf --onlySequenceNames on the legacy mmap fixture
    (paf/Makefile:20-22)."""
    got = run_tool(["hal_tpu.tools.hal2paf", "--onlySequenceNames", small_mmap10])
    want = _golden(REF + "/paf/tests/expected/hal2pafSmallMMapTest.paf.gz")
    assert got == want


def test_hal2paf_mouse_rat():
    """hal2paf on the real cactus-produced mr.hal (paf/Makefile:24-26)."""
    got = run_tool(["hal_tpu.tools.hal2paf", REF + "/paf/tests/input/mr.hal"])
    want = _golden(REF + "/paf/tests/expected/hal2pafMouseRatTest.paf.gz")
    assert got == want


def test_validate_mouse_rat():
    """Our structural validation passes on the real reference HDF5 file."""
    got = run_tool(["hal_tpu.tools.halValidate", REF + "/paf/tests/input/mr.hal"])
    assert b"File valid" in got
