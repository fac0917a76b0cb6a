"""chip_smoke.py: its phases run end to end at tiny sizes on the CPU
(the same code that runs on the card at the benchmark's sizes), main()
refuses to run without a GPU, and on a machine with one the whole script
passes (`gpu` marker)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import bench
import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("smoke"))
    lift = bench.build_alignment(n_bot=512, seg_len=300)
    maf = bench.build_maf_alignment(n_segments=2048)
    return (tmp, cs.save_fixture(lift, os.path.join(tmp, "lift.halz")),
            cs.save_fixture(maf, os.path.join(tmp, "maf.halz")))


def test_liftover_phase(fixtures):
    tmp, lift, _ = fixtures
    rec = cs.phase_liftover(lift, tmp, n_intervals=2000, batch=512)
    assert rec["byte_equal"] and rec["output_bytes"] > 0
    assert rec["memory"]["output_size_in_bytes"] > 0


def test_maf_phase(fixtures):
    tmp, _, maf = fixtures
    rec = cs.phase_maf(maf, tmp, width=60000)
    assert rec["engine_device"] and rec["byte_equal"]


def test_depth_phase(fixtures):
    tmp, lift, _ = fixtures
    rec = cs.phase_depth(lift, tmp, width=40000)
    assert rec["byte_equal"] and rec["genomes"] > 1


def test_phylop_phase():
    rec = cs.phase_phylop(n_patterns=300, n_leaves=6)
    assert rec["dtype"] == "float64"
    assert rec["max_abs_diff"] <= cs.PHYLOP_ATOL


def test_bench_lookup(tmp_path):
    """bench.py --lookup's measurement at a tiny size: every lookup is
    timed at each width and in a whole batch (each checked equal inside),
    and the trace is read (no GPU kernels on the CPU)."""
    aln = bench.build_alignment(n_bot=512, seg_len=300)
    src, tgt = bench.pick_pair(aln)
    rec = bench.bench_lookup(aln, src, tgt, n_intervals=512,
                             widths=(None, 300), iters=2,
                             trace_dir=str(tmp_path))
    assert len(rec["lookup_s"]) == 2
    for row in list(rec["lookup_s"].values()) + [rec["batch_s"]]:
        assert set(row) == set(bench.LOOKUPS)
        assert all(t > 0 for t in row.values())
    assert rec["trace"]["device_ns"] == 0


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert cs.main(argv) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_fails_outside_the_repo(tmp_path):
    """Alone in a directory the script cannot import the package: it exits
    non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    from conftest import gpu_env

    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, env=gpu_env(),
                       timeout=1500)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
