#!/usr/bin/env python
"""Run hal_tpu's device path once on a GPU and check every result.

    python chip_smoke.py           # one card: liftover, MAF, depth, phyloP
    python chip_smoke.py --four    # four cards: only the sharded steps

Each phase drives the tools a user calls (halLiftover --batchSize,
hal2maf --device, halAlignmentDepth --device) or the library's device
fit (phyloP) at the benchmark's fixture sizes, and compares the output
with the host engines: byte-equal for the integer traversals, within a
stated tolerance for phyloP.  Every phase prints one JSON line with its
set-up, compile and steady-state seconds and the compiled program's
memory analysis.  The card's name and power limit are printed first; the
last line is {"ok": true, "device": {...}} as JAX reports the device.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails.  Everything runs in this one process, so the card is held once.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# phyloP: the device fit runs in float64, so it must match the float64
# numpy fit to rounding; 1e-6 in score units (-log10 p) is the bound
PHYLOP_ATOL = 1e-6


def log(rec: dict) -> None:
    print(json.dumps(rec, default=float), flush=True)


def memory_of(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def steady(fn, n: int = 5) -> float:
    """Median seconds of fn() with its device work waited for."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run_tool(module, argv) -> str:
    """Run a tool's main in this process; returns what it wrote to stderr
    (echoed) and raises when it fails."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = module.main(argv)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        raise RuntimeError("%s %s exited %d: %s"
                           % (module.__name__, " ".join(argv), rc,
                              err.getvalue()[-2000:]))
    return err.getvalue()


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def save_fixture(aln, path: str) -> str:
    from hal_tpu.storage import halz

    halz.save(aln, path)
    return path


# --------------------------------------------------------------- phases

def phase_liftover(hal: str, tmp: str, n_intervals: int = 1 << 17,
                   batch: int = 1 << 16, max_len: int = 200,
                   seed: int = 3) -> dict:
    """halLiftover --batchSize on seeded BED intervals of up to max_len bp,
    byte-equal to the host bulk mapper (Liftover.convert_batched on the
    host)."""
    import jax.numpy as jnp

    import bench
    from hal_tpu import open_alignment
    from hal_tpu.ops import segmap_jax as sj
    from hal_tpu.ops.liftover import Liftover
    from hal_tpu.tools import halLiftover

    t0 = time.time()
    aln = open_alignment(hal)
    src, tgt = bench.pick_pair(aln)
    g = aln.open_genome(src)
    rng = np.random.default_rng(seed)
    seq_len = np.diff(np.asarray(g.seq_start, np.int64))
    ok_seq = np.flatnonzero(seq_len > max_len)
    si = rng.choice(ok_seq, n_intervals, p=seq_len[ok_seq] / seq_len[ok_seq].sum())
    start = (rng.random(n_intervals) * (seq_len[si] - max_len)).astype(np.int64)
    end = start + rng.integers(1, max_len + 1, n_intervals)
    bed = os.path.join(tmp, "in.bed")
    with open(bed, "w") as f:
        f.writelines("%s\t%d\t%d\n" % (g.seq_names[s], a, b)
                     for s, a, b in zip(si, start, end))
    mapper = sj.BatchMapper(aln, src, tgt)
    base = np.asarray(g.seq_start, np.int64)[si[:batch]]
    lo = jnp.asarray(base + start[:batch], mapper.dtype)
    hi = jnp.asarray(base + end[:batch], mapper.dtype)
    own = jnp.arange(lo.shape[0], dtype=mapper.dtype)
    caps = mapper._caps(int(lo.shape[0]), 4)
    setup = time.time() - t0

    t0 = time.time()
    compiled = sj._map_batch_jit.lower(mapper.path, lo, hi, own,
                                       caps=caps).compile()
    compile_s = time.time() - t0

    out_dev = os.path.join(tmp, "device.bed")
    t0 = time.time()
    run_tool(halLiftover, [hal, src, bed, tgt, out_dev,
                           "--batchSize", str(batch)])
    tool_s = time.time() - t0
    out_host = os.path.join(tmp, "host.bed")
    with open(bed) as fin, open(out_host, "w") as fout:
        Liftover(aln, src, tgt).convert_batched(fin, fout, 0,
                                                batch_size=batch,
                                                use_device=False)
    got, want = read(out_dev), read(out_host)
    rec = dict(phase="liftover", src=src, tgt=tgt, intervals=n_intervals,
               batch=batch, setup_s=setup, compile_s=compile_s,
               tool_s=tool_s,
               steady_batch_s=steady(lambda: compiled(mapper.path, lo, hi,
                                                      own)),
               memory=memory_of(compiled), output_bytes=len(got),
               byte_equal=got == want)
    log(rec)
    if not rec["byte_equal"] or not got:
        raise AssertionError("halLiftover --batchSize output differs from "
                             "the host bulk mapper")
    return rec


def phase_maf(hal: str, tmp: str, width: int = 8 << 20) -> dict:
    """hal2maf --device over `width` bases of the reference's first
    sequence, byte-equal to hal2maf on the native engine."""
    from hal_tpu import open_alignment
    from hal_tpu.ops.column_jax import DeviceColumnEngine
    from hal_tpu.tools import hal2maf

    aln = open_alignment(hal)
    ref = [n for n in aln.genome_names() if aln.tree.is_leaf(n)][0]
    g = aln.open_genome(ref)
    width = min(width, int(g.seq_length(0)))
    argv = [hal, None, "--refGenome", ref, "--refSequence", g.seq_names[0],
            "--length", str(width)]
    t0 = time.time()
    eng = DeviceColumnEngine(aln, ref)
    win = min(1 << 22, width)  # hal2maf --device's window
    fn, args, kw = eng.packed_program(0, win)
    setup = time.time() - t0
    t0 = time.time()
    compiled = fn.lower(*args, **kw).compile()
    compile_s = time.time() - t0

    out_dev = os.path.join(tmp, "device.maf")
    t0 = time.time()
    err = run_tool(hal2maf, [argv[0], out_dev] + argv[2:] + ["--device"])
    tool_s = time.time() - t0
    out_nat = os.path.join(tmp, "native.maf")
    run_tool(hal2maf, [argv[0], out_nat] + argv[2:])
    got, want = read(out_dev), read(out_nat)
    rec = dict(phase="maf", ref=ref, columns=width, programs=len(eng.jobs),
               setup_s=setup, compile_s=compile_s, tool_s=tool_s,
               steady_window_s=steady(lambda: compiled(*args)),
               window=win, memory=memory_of(compiled),
               engine_device="engine=device+native-assembler" in err,
               output_bytes=len(got), byte_equal=got == want)
    log(rec)
    if not rec["engine_device"]:
        raise AssertionError("hal2maf --device did not run the device "
                             "engine: " + err)
    if not rec["byte_equal"] or not got:
        raise AssertionError("hal2maf --device differs from the native "
                             "engine")
    return rec


def phase_depth(hal: str, tmp: str, width: int = 16 << 20) -> dict:
    """halAlignmentDepth --device over `width` bases of the first leaf's
    first sequence, byte-equal to the host engine's wiggle."""
    from hal_tpu import open_alignment
    from hal_tpu.ops import depth
    from hal_tpu.ops.column import compute_scope
    from hal_tpu.tools import halAlignmentDepth

    aln = open_alignment(hal)
    ref = [n for n in aln.genome_names() if aln.tree.is_leaf(n)][0]
    g = aln.open_genome(ref)
    width = min(width, int(g.seq_length(0)))
    t0 = time.time()
    scope, root = compute_scope(aln, ref)
    eng = depth.DepthEngine(aln, ref, 0, width, scope, root)
    setup = time.time() - t0
    t0 = time.time()
    compiled = [depth._depth_one.lower(
        path, lo, hi, caps=caps, window=width, count_dupes=False).compile()
        for (path, lo, hi, caps) in eng.jobs]
    compile_s = time.time() - t0
    largest = max(compiled, key=lambda c: c.memory_analysis()
                  .temp_size_in_bytes)

    argv = [hal, ref, "--refSequence", g.seq_names[0], "--length",
            str(width), "--outWiggle"]
    out_dev = os.path.join(tmp, "device.wig")
    t0 = time.time()
    run_tool(halAlignmentDepth, argv + [out_dev, "--device"])
    tool_s = time.time() - t0
    out_host = os.path.join(tmp, "host.wig")
    run_tool(halAlignmentDepth, argv + [out_host])
    got, want = read(out_dev), read(out_host)
    rec = dict(phase="depth", ref=ref, columns=width, genomes=len(eng.jobs),
               setup_s=setup, compile_s=compile_s, tool_s=tool_s,
               steady_s=steady(lambda: eng.run_device_only()[2]),
               memory_largest=memory_of(largest), output_bytes=len(got),
               byte_equal=got == want)
    log(rec)
    if not rec["byte_equal"] or not got:
        raise AssertionError("halAlignmentDepth --device differs from the "
                             "host engine")
    return rec


def phase_phylop(n_patterns: int = 1 << 16, n_leaves: int = 10,
                 seed: int = 5) -> dict:
    """The device phyloP fit (float64) on seeded patterns over a seeded
    neutral model, against the numpy fit within PHYLOP_ATOL."""
    from hal_tpu.phylop import NeutralModel, random_mod_text, score_patterns
    from hal_tpu.phylop_jax import DevicePhyloP

    t0 = time.time()
    mod = NeutralModel.from_mod_text(random_mod_text(seed, n_leaves))
    leaves = [n for n in mod.tree.names() if mod.tree.is_leaf(n)]
    leaf_idx = {n: i for i, n in enumerate(leaves)}
    pats = np.random.default_rng(seed).integers(0, 5, (n_patterns,
                                                       len(leaves)))
    dev = DevicePhyloP(mod, leaf_idx, "CONACC")
    setup = time.time() - t0
    t0 = time.time()
    dev.fit(pats)
    compile_s = time.time() - t0
    (pad, fn), = dev._jit_cache.items()
    codes = np.full((len(leaves), pad), 4, np.int32)
    codes[:, :n_patterns] = pats[:, [leaf_idx[n] for n in dev._leaves]].T
    got = dev.score_patterns(pats)
    t0 = time.time()
    want = score_patterns(mod, leaf_idx, pats, "CONACC")
    numpy_s = time.time() - t0
    diff = float(np.abs(got - want).max())
    rec = dict(phase="phylop", patterns=n_patterns, dtype=str(dev.dtype),
               setup_s=setup, compile_s=compile_s,
               steady_fit_s=steady(lambda: fn(codes)), numpy_fit_s=numpy_s,
               memory=memory_of(fn.lower(codes).compile()),
               max_abs_diff=diff, tolerance=PHYLOP_ATOL)
    log(rec)
    if not diff <= PHYLOP_ATOL:
        raise AssertionError("device phyloP differs from numpy by %g" % diff)
    return rec


def phase_four(lift_aln, maf_aln, n_devices: int = 4,
               n_intervals: int = 1 << 20, max_len: int = 200,
               maf_width: int = 8 << 20, n_sample: int | None = 1024,
               exact_maf: bool = False, seed: int = 1) -> dict:
    """The sharded liftover steps (replicated tables, table-sharded, ring)
    and the sharded column step on a mesh of n_devices, each compared with
    the one-device run of the same program and with the host engines, and
    each output's shards checked to sit on distinct devices.

    The one-device liftover is checked against the host mapper on
    n_sample owners, or on all of them when n_sample is None, and its
    base count against the host sizing twin (_HostSim).  The column
    step's MAF is checked against the native engine, and with exact_maf
    also against the Python exact DFS (iter_slices_exact)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from hal_tpu.ops import column_jax as cj
    from hal_tpu.ops import segmap_host as sm
    from hal_tpu.ops import segmap_jax as sj
    from hal_tpu.ops.column_native import NativeMafExporter
    from hal_tpu.parallel.ring_sharded import (build_ring_path,
                                               make_ring_sharded_step)
    from hal_tpu.parallel.sharded import (make_mesh, make_sharded_step,
                                          make_table_sharded_step,
                                          shard_batch, shard_path_tables)

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError("need %d devices, have %d" % (n_devices,
                                                          len(devices)))

    def on_distinct_devices(arr) -> bool:
        devs = [s.device for s in arr.addressable_shards]
        return len(devs) == n_devices and len(set(devs)) == n_devices

    def rows(F) -> np.ndarray:
        M = np.asarray(F).astype(np.int64)
        M = M[:6, M[sj.C_VALID] > 0]
        return M[:, np.lexsort(M[::-1])]

    aln = lift_aln
    src, tgt = bench.pick_pair(aln)
    sg, tg = aln.open_genome(src), aln.open_genome(tgt)
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, sg.length - max_len, n_intervals).astype(np.int64)
    hi = lo + rng.integers(1, max_len + 1, n_intervals)
    owner = np.arange(n_intervals, dtype=np.int64)
    path = sj.PathData.build(aln, src, tgt)
    dt = path.levels[0].grid.dtype
    t0 = time.time()
    totals, _ = sj.host_path_totals(aln, src, tgt, lo, hi)
    caps1 = sj.caps_from_totals(path, totals)
    F1 = sj._map_batch_jit(path, jax.numpy.asarray(lo, dt),
                           jax.numpy.asarray(hi, dt),
                           jax.numpy.asarray(owner, dt), caps1)[0]
    one = rows(F1)
    rec = dict(phase="four", devices=[str(d) for d in devices],
               intervals=n_intervals, one_device_fragments=int(one.shape[1]),
               one_device_s=time.time() - t0)

    # host oracle: the (owner, src base, tgt base) set of the mapping,
    # per sampled owner, or the (src base, tgt base) set of the whole batch
    def pairs(M, owner=True):
        ln = M[1] - M[0]
        rep = np.repeat(np.arange(M.shape[1]), ln)
        k = np.arange(int(ln.sum())) - (np.cumsum(ln) - ln)[rep]
        tpos = np.where(M[4][rep] > 0, M[3][rep] - 1 - k, M[2][rep] + k)
        cols = [M[0][rep] + k, tpos]
        return np.unique(np.stack(([M[5][rep]] if owner else []) + cols, 1),
                         axis=0)

    def host_rows(fr, o):
        return np.stack([fr.src_lo, fr.src_hi, fr.tgt_lo, fr.tgt_hi,
                         fr.rev.astype(np.int64), np.full(len(fr), o)])

    if n_sample is None:
        want = pairs(host_rows(sm.map_source(aln, src, lo, hi, tgt), -1),
                     owner=False)
        got = pairs(one, owner=False)
    else:
        sample = np.sort(rng.choice(n_intervals, n_sample, replace=False))
        want = pairs(np.concatenate(
            [host_rows(sm.map_source(aln, src, lo[o:o + 1], hi[o:o + 1],
                                     tgt), o) for o in sample], axis=1))
        got = pairs(one[:, np.isin(one[5], sample)])
    rec["host_owners"] = n_intervals if n_sample is None else n_sample
    rec["one_device_equals_host"] = bool(np.array_equal(got, want))
    if not rec["one_device_equals_host"]:
        raise AssertionError("one-device liftover differs from the host "
                             "mapper")
    # every fragment base, un-deduped: the host sizing twin's count
    sim = sj._HostSim(aln, do_dupes=True)
    t_lo, t_hi, cur = lo.copy(), hi.copy(), src
    for nxt in aln.tree.path(src, tgt)[1:]:
        t_lo, t_hi, _, _ = sim.level(cur, nxt, t_lo, t_hi, rings=True)
        cur = nxt
    n_bases = int((t_hi - t_lo).sum())
    rec["host_bases"] = n_bases
    if int((one[1] - one[0]).sum()) != n_bases:
        raise AssertionError("one-device liftover base count %d != host "
                             "%d" % (int((one[1] - one[0]).sum()), n_bases))

    def per_shard_caps(n_shards):
        per = n_intervals // n_shards
        maxed = None
        sim = sj._HostSim(aln, do_dupes=True)
        for k in range(n_shards):
            tk, _ = sj.host_path_totals(aln, src, tgt,
                                        lo[k * per:(k + 1) * per],
                                        hi[k * per:(k + 1) * per], sim=sim)
            maxed = tk if maxed is None else [
                (max(a, c), max(b, d)) for (a, b), (c, d) in zip(maxed, tk)]
        return sj.caps_from_totals(path, maxed)

    def check(name, F, ovf, timed, extra=None):
        if np.asarray(ovf).any():
            raise AssertionError(name + " overflowed its capacities")
        r = rows(F)
        step = dict(equal_to_one_device=bool(np.array_equal(r, one)),
                    shards_on_distinct_devices=on_distinct_devices(F),
                    **timed, **(extra or {}))
        rec[name] = step
        if not step["equal_to_one_device"]:
            raise AssertionError(name + " differs from the one-device run")
        if not step["shards_on_distinct_devices"]:
            raise AssertionError(name + " shards do not sit on distinct "
                                 "devices")

    def timed_run(step, *args):
        t0 = time.time()
        out = step(*args)
        jax.block_until_ready(out)
        first = time.time() - t0
        return out, dict(compile_and_first_s=first,
                         steady_s=steady(lambda: step(*args), n=3))

    # 1: replicated tables, queries over 'data', histogram over 'coord'
    n_coord = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices // n_coord, n_coord, devices)
    n_bins = 16 * n_coord
    step1 = make_sharded_step(path, per_shard_caps(n_devices // n_coord),
                              tg.length, n_bins, mesh)
    (F, cov), t = timed_run(step1, *shard_batch(mesh, lo, hi, owner))
    cov_sum = int(np.asarray(cov).sum())
    check("replicated_step", F, np.zeros(1, bool), t,
          dict(mesh=[n_devices // n_coord, n_coord], coverage_sum=cov_sum,
               coverage_expected=n_bases))
    if cov_sum != n_bases:
        raise AssertionError("replicated step coverage %d != %d"
                             % (cov_sum, n_bases))

    # 2: tables at rest sharded 1/D, all-gathered per level
    flat = make_mesh(n_devices, 1, devices)
    caps_d = per_shard_caps(n_devices)
    path_sh = shard_path_tables(path, flat)
    args = shard_batch(flat, lo, hi, owner)
    (F, ovf), t = timed_run(make_table_sharded_step(path_sh, caps_d, flat),
                            *args)
    check("table_sharded_step", F, ovf, t, dict(
        tables_on_distinct_devices=on_distinct_devices(
            path_sh.levels[0].grid)))
    if not rec["table_sharded_step"]["tables_on_distinct_devices"]:
        raise AssertionError("sharded tables do not sit on distinct devices")

    # 3: shard-local traversal, fragments routed all_to_all per level
    per = n_intervals // n_devices
    caps3 = tuple((sj._next_pow2(per * 8), sj._next_pow2(per * 8),
                   sj._next_pow2(per * 16), sj._next_pow2(per * 16))
                  for _ in path.levels)
    (F, ovf), t = timed_run(make_ring_sharded_step(
        build_ring_path(path, n_devices), caps3, flat), *args)
    check("ring_sharded_step", F, ovf, t)

    # 4: sharded column step over maf_width bases, MAF byte-equal to the
    # native engine and to the one-device engine (and to the exact DFS)
    ref = [n for n in maf_aln.genome_names() if maf_aln.tree.is_leaf(n)][0]
    width = min(maf_width, int(maf_aln.open_genome(ref).length))
    eng = cj.DeviceColumnEngine(maf_aln, ref)
    edges = np.linspace(0, width, n_devices + 1).astype(np.int64)
    caps_all, oc_all = cj.size_sharded_caps(eng, edges)
    cstep = cj.make_sharded_column_step(eng, caps_all, oc_all, flat)
    sh = NamedSharding(flat, P("data"))
    lo_sh = jax.device_put(edges[:-1].copy(), sh)
    hi_sh = jax.device_put(edges[1:].copy(), sh)
    outs, t = timed_run(cstep, lo_sh, hi_sh)
    frags = cj.collect_sharded(eng, outs, edges)

    def maf(export):
        ex = NativeMafExporter(maf_aln, ref)
        try:
            return export(ex) + ex.finish()
        finally:
            ex.close()

    got = maf(lambda ex: ex.export_frags(0, width, frags))
    want = maf(lambda ex: ex.export(0, width))
    one_dev = maf(lambda ex: eng.export_native(ex, 0, width))
    rec["column_step"] = c = dict(
        columns=width, programs=len(eng.jobs), maf_bytes=len(want),
        maf_equal_to_native=got == want, maf_equal_to_one_device=got == one_dev,
        shards_on_distinct_devices=on_distinct_devices(outs[0][0]), **t)
    if exact_maf:
        from hal_tpu.io.maf_io import MafBlockBuilder
        from hal_tpu.ops.column import iter_slices_exact

        def maf_py(slices):
            b = MafBlockBuilder(maf_aln, ref, ucsc_names=True)
            blocks = list(b.feed(slices))
            tail = b.flush_end()
            return "\n".join(blocks + ([tail] if tail else []))

        c["maf_equal_to_exact_dfs"] = (
            maf_py(cj.slices_from_frags(maf_aln, ref, 0, width, frags))
            == maf_py(iter_slices_exact(maf_aln, ref, 0, width)))
    log(rec)
    if not (c["maf_equal_to_native"] and c["maf_equal_to_one_device"]
            and c.get("maf_equal_to_exact_dfs", True) and want):
        raise AssertionError("sharded column step MAF differs")
    if not c["shards_on_distinct_devices"]:
        raise AssertionError("column step shards do not sit on distinct "
                             "devices")
    return rec


# ----------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded steps, on four cards")
    o = ap.parse_args(argv)

    import bench

    print(bench.card_line(), flush=True)
    import jax

    print("jax %s %s" % (jax.__version__, jax.devices()), flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write("chip_smoke: no GPU (JAX platform %s)\n"
                         % dev.platform)
        return 1
    n_dev = 4 if o.four else 1

    from hal_tpu.native import build
    from hal_tpu.ops.segmap_jax import enable_compile_cache

    t0 = time.time()
    if not build("libhaltpu.so", "libhalcolumn.so"):
        raise RuntimeError("cannot build the native libraries")
    enable_compile_cache()
    log(dict(phase="build", native_s=time.time() - t0))

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        lift = bench.build_alignment()
        maf = bench.build_maf_alignment()
        if o.four:
            log(dict(phase="fixtures", s=time.time() - t0))
            phase_four(lift, maf, n_devices=n_dev)
        else:
            lift_hal = save_fixture(lift, os.path.join(tmp, "lift.halz"))
            maf_hal = save_fixture(maf, os.path.join(tmp, "maf.halz"))
            del lift, maf
            log(dict(phase="fixtures", s=time.time() - t0))
            phase_liftover(lift_hal, tmp)
            phase_maf(maf_hal, tmp)
            phase_depth(lift_hal, tmp)
            phase_phylop()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
