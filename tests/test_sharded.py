"""Multi-device SPMD tests on the virtual 8-CPU mesh (conftest forces it):
the sharded liftover+depth step must agree with the single-device host
mapper, and the driver dryrun must execute."""

import numpy as np
import jax
import pytest

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 (virtual) devices")


def _fixture():
    from hal_tpu.randgen import create_random_alignment

    return create_random_alignment(
        seed=3, max_genomes=5, min_genomes=4,
        min_segment_length=10, max_segment_length=18,
        min_segments=30, max_segments=60)


def test_mesh_runs_on_8_devices():
    assert jax.device_count() >= 8
    assert jax.devices()[0].platform == "cpu"


def test_sharded_step_matches_host_mapper():
    from hal_tpu.ops import segmap_host as sm
    from hal_tpu.ops.segmap_jax import PathData
    from hal_tpu.parallel.sharded import make_mesh, make_sharded_step, shard_batch

    aln = _fixture()
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    sg, tg = aln.open_genome(src), aln.open_genome(tgt)
    path = PathData.build(aln, src, tgt)

    mesh = make_mesh(4, 2)
    n = 32
    rng = np.random.default_rng(0)
    lo = rng.integers(0, max(sg.length - 20, 1), n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(1, 20, n), sg.length).astype(np.int64)
    owner = np.arange(n, dtype=np.int64)
    caps = tuple(int(n * 8 * (min(l.max_ring + 1, 4) if l.max_ring else 1))
                 for l in path.levels)
    n_bins = 16
    step = make_sharded_step(path, caps, tg.length, n_bins, mesh)
    F, cov = step(*shard_batch(mesh, lo, hi, owner))
    jax.block_until_ready(cov)

    from hal_tpu.ops import segmap_jax as sjx

    M = np.asarray(F)  # (8, total_cap), fragments sharded along axis 1
    s_lo, s_hi = M[sjx.C_SLO], M[sjx.C_SHI]
    t_lo, t_hi = M[sjx.C_TLO], M[sjx.C_THI]
    rev, own, valid = M[sjx.C_REV], M[sjx.C_OWN], M[sjx.C_VALID]

    # collective-plumbing oracle: the psum/scatter histogram must equal the
    # histogram recomputed on host from the device's own valid fragments
    v = np.asarray(valid).astype(bool).reshape(-1)
    tl = np.asarray(t_lo).reshape(-1)[v]
    th = np.asarray(t_hi).reshape(-1)[v]
    want = np.zeros(n_bins, dtype=np.int64)
    for flo, fhi in zip(tl, th):
        b = min(max(int(flo) * n_bins // max(tg.length, 1), 0), n_bins - 1)
        want[b] += fhi - flo
    got = np.asarray(cov).reshape(-1)
    assert np.array_equal(got, want)

    # mapper oracle: per-owner (src,tgt,rev) base pairs == host mapper's,
    # for each query interval independently (per-interval call semantics,
    # reference BlockLiftover::liftInterval)
    s_lo_v = np.asarray(s_lo).reshape(-1)[v]
    s_hi_v = np.asarray(s_hi).reshape(-1)[v]
    rev_v = np.asarray(rev).reshape(-1)[v]
    own_v = np.asarray(own).reshape(-1)[v]
    got_pairs = set()
    for a, b, c, d, r, o in zip(s_lo_v, s_hi_v, tl, th, rev_v, own_v):
        for k in range(b - a):
            tp = (d - 1 - k) if r else (c + k)
            got_pairs.add((int(o), int(a + k), int(tp)))
    want_pairs = set()
    for i, (l, h) in enumerate(zip(lo, hi)):
        frags = sm.map_source(aln, src, np.array([l]), np.array([h]), tgt)
        for a, b, c, d, r in zip(frags.src_lo, frags.src_hi, frags.tgt_lo,
                                 frags.tgt_hi, frags.rev):
            for k in range(b - a):
                tp = (d - 1 - k) if r else (c + k)
                want_pairs.add((i, int(a + k), int(tp)))
    assert got_pairs == want_pairs


def test_ensure_virtual_devices_raises_off_cpu(monkeypatch):
    """Too few devices on an accelerator platform is an error, never a
    silent switch to the CPU."""
    import jax
    import pytest

    from hal_tpu.parallel import sharded

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 4 devices"):
        sharded.ensure_virtual_devices(4)


def test_driver_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_bench_scaling_harness():
    """Scaling harness (BASELINE config #5) runs and reports efficiency
    rows on the virtual mesh."""
    import json
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "hal_tpu.tools.benchScaling",
         "--devices", "1,2", "--nIntervals", "2048", "--nGenomes", "4",
         "--nSegments", "100", "--iters", "2"],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ,
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=2"},
    )
    assert r.returncode == 0, r.stderr
    lines = [json.loads(x) for x in r.stdout.splitlines()]
    summary = lines[-1]
    assert summary["metric"] == "sharded_scaling"
    assert [row["devices"] for row in summary["results"]] == [1, 2]
    assert summary["results"][0]["scaling_efficiency"] == 1.0
