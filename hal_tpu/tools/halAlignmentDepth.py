"""halAlignmentDepth — alignment depth wiggle
(reference alignmentDepth/halAlignmentDepth.cpp)."""

from __future__ import annotations

import sys

from hal_tpu import open_alignment
from hal_tpu.ops.column import compute_scope
from hal_tpu.ops.depth import depth_counts, write_wiggle
from hal_tpu.tools import HalError, add_storage_options, make_parser, out_stream, tool_main

WINDOW = 1 << 20


def run(argv=None):
    p = make_parser("halAlignmentDepth", "Make alignment depth wiggle plot for a genome")
    p.add_argument("halPath")
    p.add_argument("refGenome")
    p.add_argument("--outWiggle", default="stdout")
    p.add_argument("--refSequence", default="")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    p.add_argument("--rootGenome", default="")
    p.add_argument("--targetGenomes", default="")
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--countDupes", action="store_true")
    p.add_argument("--noAncestors", action="store_true")
    p.add_argument("--device", action="store_true",
                   help="run the column-depth engine on the device "
                        "(hal_tpu.ops.depth.depth_counts_device); output "
                        "is identical")
    add_storage_options(p)
    o = p.parse_args(argv)

    if o.rootGenome and o.targetGenomes:
        raise HalError("--rootGenome and --targetGenomes options are  mutually exclusive")

    aln = open_alignment(o.halPath)
    if aln.num_genomes == 0:
        raise HalError("input hal alignmenet is empty")
    ref = o.refGenome
    if ref not in aln.tree:
        raise HalError("Reference genome, %s, not found in alignment" % ref)
    g = aln.open_genome(ref)
    if aln.tree.children(ref) and o.noAncestors:
        raise HalError("--noAncestors cannot be used when reference genome (%s) is ancetral" % ref)

    targets = [t for t in o.targetGenomes.split(",") if t] or None
    root = o.rootGenome or None
    scope, scope_root = compute_scope(aln, ref, targets, root)

    out = out_stream(o.outWiggle)
    if o.device:
        from hal_tpu.ops.segmap_jax import enable_compile_cache

        enable_compile_cache()

    def emit(si, s, ln):
        base = int(g.seq_start[si])
        counts_parts = []
        pos = base + s
        end = base + s + ln
        import numpy as np

        # the device engine drains RLE runs (bytes ~ runs, not columns),
        # so much larger windows amortize per-window host sizing; the
        # dense counts vector lives in HBM (4 B/column)
        win = (1 << 26) if o.device else WINDOW
        while pos < end:
            w = min(pos + win, end)
            if o.device:
                from hal_tpu.ops.depth import depth_counts_device

                counts_parts.append(depth_counts_device(
                    aln, ref, pos, w, scope, scope_root,
                    o.countDupes, o.noAncestors)[0])
            else:
                counts_parts.append(depth_counts(aln, ref, pos, w, scope, scope_root,
                                                 o.countDupes, o.noAncestors))

            pos = w
        counts = np.concatenate(counts_parts) if counts_parts else np.zeros(0, np.int64)
        write_wiggle(out, g.seq_names[si], s, counts, o.step)

    if o.refSequence:
        si = g.sequence_index(o.refSequence)
        ln = o.length or (g.seq_length(si) - o.start)
        if o.start + ln > g.seq_length(si):
            raise HalError("Specified range is out of range for sequence %s" % o.refSequence)
        emit(si, o.start, ln)
    else:
        # genome-range scoping clipped per sequence (printGenome,
        # halAlignmentDepth.cpp:319-343)
        gstart = o.start
        glen = o.length or (g.length - gstart)
        gend = gstart + glen
        for si in range(g.num_sequences):
            lo = int(g.seq_start[si])
            hi = int(g.seq_start[si + 1])
            s = max(lo, gstart)
            e = min(hi, gend)
            if s < e:
                emit(si, s - lo, e - s)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
