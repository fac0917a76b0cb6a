"""halLiftover — BED/PSL coordinate projection CLI
(reference liftover/impl/halLiftoverMain.cpp)."""

from __future__ import annotations

import sys

from hal_tpu import open_alignment
from hal_tpu.ops.liftover import Liftover
from hal_tpu.tools import HalError, add_storage_options, make_parser, tool_main


def run(argv=None):
    p = make_parser("halLiftover", "Map BED or PSL genome interval coordinates between two genomes")
    p.add_argument("halFile")
    p.add_argument("srcGenome")
    p.add_argument("srcBed", help="input bed path, or stdin")
    p.add_argument("tgtGenome")
    p.add_argument("tgtBed", help="output bed path, or stdout")
    p.add_argument("--noDupes", action="store_true",
                   help="do not map between duplications in graph")
    p.add_argument("--append", action="store_true", help="append results to tgtBed")
    p.add_argument("--coalescenceLimit", default="",
                   help="genome at or above the MRCA at which to stop looking for homologies")
    p.add_argument("--outPSL", action="store_true")
    p.add_argument("--outPSLWithName", action="store_true")
    p.add_argument("--bedType", type=int, default=0)
    p.add_argument("--batchSize", type=int, default=0,
                   help="map this many BED lines per batch through the bulk "
                        "mapper (the device kernel when JAX has an "
                        "accelerator); "
                        "0 = per-line host mapping.  Output is identical "
                        "either way")
    add_storage_options(p)
    o = p.parse_args(argv)

    if o.bedType and not 3 <= o.bedType <= 12:
        raise HalError("--bedType must be between 3 and 12")
    out_psl = o.outPSL or o.outPSLWithName

    aln = open_alignment(o.halFile)
    if o.srcGenome not in aln.tree or o.tgtGenome not in aln.tree:
        raise HalError("source or target genome not found in alignment")
    coalescence = o.coalescenceLimit or None
    if coalescence and coalescence not in aln.tree:
        raise HalError("coalescence limit genome %s not found" % coalescence)

    lift = Liftover(aln, o.srcGenome, o.tgtGenome,
                    traverse_dupes=not o.noDupes, out_psl=out_psl,
                    psl_with_name=o.outPSLWithName, coalescence_limit=coalescence)

    in_stream = sys.stdin if o.srcBed in ("stdin", "-") else open(o.srcBed)
    if o.tgtBed in ("stdout", "-"):
        out_stream = sys.stdout
    else:
        out_stream = open(o.tgtBed, "a" if o.append else "w")
    if o.batchSize > 0:
        import jax

        use_device = jax.default_backend() != "cpu"
        if use_device:
            from hal_tpu.ops.segmap_jax import enable_compile_cache

            enable_compile_cache()
        lift.convert_batched(in_stream, out_stream, o.bedType,
                             batch_size=o.batchSize, use_device=use_device)
    else:
        lift.convert(in_stream, out_stream, o.bedType)
    if out_stream is not sys.stdout:
        out_stream.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
