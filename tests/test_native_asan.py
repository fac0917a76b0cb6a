"""ASan/UBSan coverage for native/ — the reference CI runs its whole suite
under AddressSanitizer (reference .travis.yml:24-30); these tests build the
sanitized runtime library and drive it (plus the blockViz C ABI free
contract) from ASan-instrumented C programs with leak detection on."""

import os
import shutil
import subprocess

import pytest

from hal_tpu.native import build, library_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")

pytestmark = pytest.mark.skipif(
    shutil.which("gcc") is None or shutil.which("make") is None,
    reason="no C toolchain")


def _asan_available():
    probe = "int main(){return 0;}"
    r = subprocess.run(["gcc", "-fsanitize=address", "-x", "c", "-", "-o",
                        "/dev/null"], input=probe.encode(),
                       capture_output=True)
    return r.returncode == 0


@pytest.fixture(scope="module")
def asan_lib():
    if not _asan_available():
        pytest.skip("libasan not available")
    assert build("asan")
    return os.path.join(NATIVE, "libhaltpu_asan.so")


def _run_driver(exe, *args):
    env = dict(os.environ)
    env["ASAN_OPTIONS"] = "detect_leaks=1:abort_on_error=1"
    env["UBSAN_OPTIONS"] = "halt_on_error=1"
    return subprocess.run([str(exe)] + list(args), capture_output=True,
                          env=env, timeout=300)


def test_haltpu_suite_under_asan(asan_lib, tmp_path):
    """Every libhaltpu entry point, valid + malformed inputs, exact-length
    heap buffers (no terminator) — any OOB read/write, leak, or UB fails."""
    src = os.path.join(NATIVE, "tests", "haltpu_asan_test.c")
    exe = tmp_path / "haltpu_asan_test"
    subprocess.run(["gcc", "-O1", "-g", "-fsanitize=address,undefined",
                    "-o", str(exe), src, "-ldl"], check=True)
    r = _run_driver(exe, asan_lib)
    assert r.returncode == 0, (r.stdout + r.stderr).decode()[-2000:]
    assert b"OK" in r.stdout


def test_blockviz_free_contract_under_asan(tmp_path):
    """halFreeBlockResults/halFreeBlocks/halFreeTargetDupeLists/
    halFreeSpeciesList must free every node and string exactly once
    (halFreeBlockResults contract, reference halBlockViz.cpp:195-241);
    the ASan-instrumented driver's interposed allocator verifies it."""
    if not _asan_available():
        pytest.skip("libasan not available")
    lib = library_path("libhalblockviz.so")
    if lib is None:
        pytest.skip("cannot build libhalblockviz.so")
    src = os.path.join(NATIVE, "tests", "blockviz_free_test.c")
    exe = tmp_path / "blockviz_free_test"
    subprocess.run(["gcc", "-O1", "-g", "-fsanitize=address",
                    "-o", str(exe), src, "-ldl"], check=True)
    r = _run_driver(exe, lib)
    assert r.returncode == 0, (r.stdout + r.stderr).decode()[-2000:]
    assert b"OK" in r.stdout


def test_blockviz_server_under_asan(tmp_path):
    """The Python-free blockViz server, ASan+UBSan instrumented: every
    entry point exercised (blocks across modes, dupes, species, chroms,
    dna, error path) with leak detection on."""
    if not _asan_available():
        pytest.skip("libasan not available")
    lib = library_path("libhalblockviz_native_asan.so")
    assert lib is not None

    from hal_tpu.randgen import create_random_alignment
    from hal_tpu.storage import save_alignment

    aln = create_random_alignment(seed=9, max_genomes=6, min_genomes=4,
                                  min_segment_length=4,
                                  max_segment_length=20, min_segments=10,
                                  max_segments=40)
    halz = str(tmp_path / "a.halz")
    save_alignment(aln, halz, fmt="halz")
    leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)]
    t, q = leaves[0], leaves[-1]
    chrom = aln.open_genome(t).seq_names[0]

    src = os.path.join(NATIVE, "tests", "blockviz_server_asan_test.c")
    exe = tmp_path / "bvs_asan"
    subprocess.run(["gcc", "-O1", "-g", "-fsanitize=address,undefined",
                    "-o", str(exe), src, "-ldl"], check=True)
    r = _run_driver(exe, lib, halz, q, t, chrom)
    assert r.returncode == 0, (r.stdout + r.stderr).decode()[-2500:]
    assert b"OK" in r.stdout


def test_column_engine_under_asan(asan_lib, tmp_path):
    """The full native column surface — plain export, --maxRefGap indel
    stacks, --global shared visit passes, and the fragment-table
    assembler — driven under AddressSanitizer/UBSan (leak detection off:
    the host is a full CPython).  Any OOB/UB aborts the subprocess."""
    import sys

    gcc = shutil.which("gcc")
    libasan = subprocess.run([gcc, "-print-file-name=libasan.so"],
                             capture_output=True,
                             text=True).stdout.strip()
    if not libasan or not os.path.exists(libasan):
        pytest.skip("libasan not found")
    script = tmp_path / "drive.py"
    script.write_text("""
import numpy as np
from hal_tpu.randgen import create_random_alignment
from hal_tpu.ops.column_native import NativeMafExporter, available
from hal_tpu.ops.column_jax import ColumnHostSim, build_programs, _target_frags_host
from hal_tpu.ops.column import compute_scope
assert available()
aln = create_random_alignment(seed=42, max_genomes=6, min_genomes=5,
                              min_segments=5, max_segments=20,
                              min_segment_length=3, max_segment_length=10)
leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
ref = leaves[0]
ge = int(aln.open_genome(ref).length)
ex = NativeMafExporter(aln, ref)
ex.export(0, ge); ex.finish(); ex.close()
ex = NativeMafExporter(aln, ref, max_ref_gap=8, keep_empty_ref_blocks=False)
ex.export(0, ge); ex.finish(); ex.close()
ex = NativeMafExporter(aln, leaves[0], global_mode=True)
for r in leaves:
    ex.set_ref(r)
    ex.export(0, int(aln.open_genome(r).length)); ex.finish()
ex.close()
scope, root = compute_scope(aln, ref)
sim = ColumnHostSim(aln)
frags = _target_frags_host(sim, build_programs(aln, ref, scope, root), 0, ge)
ex = NativeMafExporter(aln, ref)
ex.export_frags(0, ge, frags); ex.finish(); ex.close()
print("COLUMN-ASAN-OK")
""")
    env = dict(os.environ)
    env["HALTPU_COLUMN_LIB"] = os.path.join(NATIVE, "libhalcolumn_asan.so")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["LD_PRELOAD"] = libasan
    env["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
    env["UBSAN_OPTIONS"] = "halt_on_error=1"
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       env=env, timeout=600, cwd=REPO)
    assert r.returncode == 0, (r.stdout + r.stderr).decode()[-3000:]
    assert b"COLUMN-ASAN-OK" in r.stdout
