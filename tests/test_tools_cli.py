"""Golden-file style CLI tests (the reference's dominant test pattern:
generate with halRandGen, run tool, diff — e.g. maf/Makefile:30-86)."""

import subprocess
import sys

import pytest

TOOLS = ["halRandGen", "halValidate", "halStats", "hal2fasta"]


def run_tool(tool, *args):
    r = subprocess.run(
        [sys.executable, "-m", "hal_tpu.tools." + tool, *args],
        capture_output=True, text=True, timeout=300,
    )
    return r


@pytest.fixture(scope="module")
def halz_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("cli") / "t.halz")
    r = run_tool("halRandGen", p, "--seed", "1", "--maxGenomes", "5",
                 "--maxSegments", "30", "--maxSegmentLength", "20")
    assert r.returncode == 0, r.stderr
    return p


def test_validate(halz_file):
    r = run_tool("halValidate", halz_file)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "\nFile valid\n"


def test_stats_default(halz_file):
    r = run_tool("halStats", halz_file)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[1] == "hal v2.3"
    assert "GenomeName, NumChildren, Length, NumSequences, NumTopSegments, NumBottomSegments" in r.stdout
    assert lines[2].endswith(";")


def test_stats_modes(halz_file):
    assert run_tool("halStats", halz_file, "--root").stdout.strip() == "Genome_0"
    r = run_tool("halStats", halz_file, "--genomes")
    assert "Genome_0" in r.stdout
    r = run_tool("halStats", halz_file, "--numSegments", "Genome_0")
    assert len(r.stdout.split()) == 2
    r = run_tool("halStats", halz_file, "--chromSizes", "Genome_0")
    assert "\t" in r.stdout
    r = run_tool("halStats", halz_file, "--sequenceStats", "Genome_0")
    assert r.stdout.startswith("SequenceName, Length,")


def test_stats_bad_genome(halz_file):
    r = run_tool("halStats", halz_file, "--sequences", "NoSuchGenome")
    assert r.returncode == 1
    assert "hal exception caught" in r.stderr


def test_fasta_roundtrip_length(halz_file):
    r = run_tool("hal2fasta", halz_file, "Genome_0", "--lineWidth", "50")
    assert r.returncode == 0, r.stderr
    seq = "".join(l for l in r.stdout.splitlines() if not l.startswith(">"))
    r2 = run_tool("halStats", halz_file)
    row = [l for l in r2.stdout.splitlines() if l.startswith("Genome_0,")][0]
    length = int(row.split(", ")[2])
    assert len(seq) == length
    assert all(len(l) <= 50 for l in r.stdout.splitlines() if not l.startswith(">"))


def test_fasta_upper_and_subtree(halz_file):
    r = run_tool("hal2fasta", halz_file, "Genome_0", "--subtree", "--upper")
    assert r.returncode == 0, r.stderr
    n_headers = sum(1 for l in r.stdout.splitlines() if l.startswith(">"))
    assert n_headers >= 2  # root + at least one child
    body = "".join(l for l in r.stdout.splitlines() if not l.startswith(">"))
    assert body == body.upper()


def test_dispatcher():
    r = subprocess.run([sys.executable, "-m", "hal_tpu", "--help"],
                       capture_output=True, text=True, timeout=120)
    assert "halStats" in r.stderr


def test_hdf5_cli_flow(tmp_path):
    p = str(tmp_path / "x.hal")
    r = run_tool("halRandGen", p, "--format", "hdf5", "--seed", "2", "--maxGenomes", "4")
    assert r.returncode == 0, r.stderr
    assert run_tool("halValidate", p).returncode == 0


def test_hal2maf_device_flag_byte_equal(halz_file, tmp_path_factory):
    """hal2maf --device (device column engine + native assembler) through the
    CLI surface: byte-equal to the default engine, incl. --noDupes and
    --noAncestors."""
    import os

    d = tmp_path_factory.mktemp("h2md")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for extra in ([], ["--noDupes"], ["--noAncestors"]):
        a = str(d / ("a%d.maf" % len(extra)))
        b = str(d / ("b%d.maf" % len(extra)))
        r1 = subprocess.run(
            [sys.executable, "-m", "hal_tpu.tools.hal2maf", halz_file, a]
            + extra, capture_output=True, text=True, timeout=300)
        assert r1.returncode == 0, r1.stderr
        r2 = subprocess.run(
            [sys.executable, "-m", "hal_tpu.tools.hal2maf", halz_file, b,
             "--device"] + extra, capture_output=True, text=True,
            timeout=300, env=env)
        assert r2.returncode == 0, r2.stderr
        assert "engine=device" in r2.stderr, r2.stderr
        assert open(a, "rb").read() == open(b, "rb").read(), extra


@pytest.mark.parametrize("exc", [ValueError, RuntimeError])
def test_hal2maf_device_engine_failure_route(halz_file, tmp_path,
                                             monkeypatch, capsys, exc):
    """A ValueError from the device engine (its documented DFS key-space
    refusal) falls back to the host engine with a notice and the same
    bytes; any other failure raises."""
    from hal_tpu.ops import column_jax
    from hal_tpu.tools import hal2maf

    def refuse(*a, **kw):
        raise exc("DFS key space exceeds the dtype")

    monkeypatch.setattr(column_jax, "DeviceColumnEngine", refuse)
    want, got = str(tmp_path / "host.maf"), str(tmp_path / "dev.maf")
    assert hal2maf.main([halz_file, want]) == 0
    if exc is RuntimeError:
        with pytest.raises(RuntimeError):
            hal2maf.main([halz_file, got, "--device"])
        return
    capsys.readouterr()
    assert hal2maf.main([halz_file, got, "--device"]) == 0
    assert "device engine unavailable" in capsys.readouterr().err
    assert open(got, "rb").read() == open(want, "rb").read()


@pytest.mark.parametrize("num_proc", [1, 3])
def test_phylop_mp_keeps_workers_off_the_device(tmp_path, monkeypatch,
                                                num_proc):
    """halPhyloPMP hands the device to at most one worker: with several
    workers each runs halPhyloP --device off."""
    from hal_tpu.tools import halPhyloPMP

    cmds = []
    monkeypatch.setattr(halPhyloPMP, "get_hal_sequences",
                        lambda hal, genome: ["s0", "s1", "s2"])
    monkeypatch.setattr(halPhyloPMP, "run_parallel_shell_commands",
                        lambda c, n: cmds.extend(c))
    halPhyloPMP.run(["x.hal", "g", "m.mod", str(tmp_path / "o.wig"),
                     "--numProc", str(num_proc)])
    assert len(cmds) == 3
    assert all(c.endswith(" --device off") == (num_proc > 1) for c in cmds)
