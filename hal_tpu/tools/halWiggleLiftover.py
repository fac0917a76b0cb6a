"""halWiggleLiftover — project wiggle signal between genomes
(reference liftover/impl/halWiggleLiftover.cpp, halWiggleLiftoverMain.cpp).

Values are mapped per covered position; the reference's WiggleTiles
accumulator (liftover/inc/halWiggleTiles.h:55-114) becomes sorted
(position, value) arrays merged at the end."""

from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np

from hal_tpu import open_alignment
from hal_tpu.io.wiggle import read_wiggle, write_wiggle_runs
from hal_tpu.ops import segmap_host as sm
from hal_tpu.tools import HalError, add_storage_options, make_parser, tool_main


def run(argv=None):
    p = make_parser("halWiggleLiftover", "Map wiggle genome interval coordinates between two genomes")
    p.add_argument("halFile")
    p.add_argument("srcGenome")
    p.add_argument("srcWig", help="input .wig (or stdin)")
    p.add_argument("tgtGenome")
    p.add_argument("tgtWig", help="output .wig (or stdout)")
    p.add_argument("--noDupes", action="store_true")
    p.add_argument("--append", action="store_true")
    p.add_argument("--unique", action="store_true")
    p.add_argument("--batchSize", type=int, default=0,
                   help="map wiggle runs through the device bulk mapper "
                        "when JAX has an accelerator; output is identical")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    if o.srcGenome not in aln.tree or o.tgtGenome not in aln.tree:
        raise HalError("source or target genome not found")
    sg = aln.open_genome(o.srcGenome)
    tg = aln.open_genome(o.tgtGenome)

    device_path = None
    if o.batchSize > 0:
        import jax

        if jax.default_backend() != "cpu":
            from hal_tpu.ops import segmap_jax as sj

            sj.enable_compile_cache()
            device_path = sj.PathData.build(aln, o.srcGenome, o.tgtGenome,
                                            do_dupes=not o.noDupes)

    def map_intervals(lo, hi):
        """Device or host interval mapping with identical fragment output
        (device fragments pass through the same atomize+dedup canonical
        form map_source ends with)."""
        if device_path is not None:
            from hal_tpu.ops import segmap_jax as sj

            s_lo, s_hi, t_lo, t_hi, rev, _own = sj.map_batch(device_path, lo, hi)
            return sm.atomize(sm.Fragments(
                np.asarray(s_lo, np.int64), np.asarray(s_hi, np.int64),
                np.asarray(t_lo, np.int64), np.asarray(t_hi, np.int64),
                np.asarray(rev, np.uint8)).dedup())
        return sm.map_source(aln, o.srcGenome, lo, hi, o.tgtGenome,
                             do_dupes=not o.noDupes)

    in_stream = sys.stdin if o.srcWig in ("stdin", "-") else open(o.srcWig)
    out = sys.stdout if o.tgtWig in ("stdout", "-") else open(
        o.tgtWig, "a" if o.append else "w")

    # per-target-sequence accumulated (pos, val) pairs
    acc_pos = defaultdict(list)
    acc_val = defaultdict(list)

    for seq_name, positions, values in read_wiggle(in_stream):
        try:
            si = sg.sequence_index(seq_name)
        except KeyError:
            sys.stderr.write("Unable to find sequence %s in genome %s\n"
                             % (seq_name, o.srcGenome))
            continue
        base = int(sg.seq_start[si])
        gpos = positions + base
        # map runs of consecutive positions as intervals
        brk = np.concatenate([[True], gpos[1:] != gpos[:-1] + 1])
        starts = np.flatnonzero(brk)
        ends = np.append(starts[1:], len(gpos))
        lo = gpos[starts]
        hi = gpos[ends - 1] + 1
        frags = map_intervals(lo, hi)
        # value lookup per source position
        order = np.argsort(gpos, kind="stable")
        sp = gpos[order]
        sv = values[order]
        for i in range(len(frags)):
            sl, sh = int(frags.src_lo[i]), int(frags.src_hi[i])
            n = sh - sl
            j0 = int(np.searchsorted(sp, sl))
            vals = sv[j0:j0 + n]
            if bool(frags.rev[i]):
                tpos = np.arange(int(frags.tgt_hi[i]) - 1, int(frags.tgt_lo[i]) - 1, -1)
            else:
                tpos = np.arange(int(frags.tgt_lo[i]), int(frags.tgt_hi[i]))
            tsi = int(np.searchsorted(tg.seq_start, tpos[0], side="right")) - 1
            tbase = int(tg.seq_start[tsi])
            acc_pos[tsi].append(tpos - tbase)
            acc_val[tsi].append(vals)

    for tsi in sorted(acc_pos):
        write_wiggle_runs(out, tg.seq_names[tsi],
                          np.concatenate(acc_pos[tsi]),
                          np.concatenate(acc_val[tsi]))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
