"""halz — hal_tpu's native columnar shard storage format.

The replacement for the reference's mmap driver
(/root/reference/api/mmap_impl/): instead of one 64-GiB pre-allocated file
of offset-linked structs (mmapFile.h:23-73), an alignment is a directory of
flat .npy arrays — exactly the arrays the device kernels consume — plus a
JSON manifest:

    <path>/halz.json                     manifest: tree, metadata, genome
                                         table (dims, dtypes, per-seq info)
    <path>/<genome>/top_start.npy        int64 [n_top+1]
    <path>/<genome>/top_parent.npy       ...
    <path>/<genome>/bot_child.npy        int64 [n_bot, n_children]
    <path>/<genome>/dna.npy              uint8 nibble-packed
    ...

Properties the mmap driver bought with raw structs are preserved or
improved:
  * zero-parse open: np.load(mmap_mode='r') demand-pages straight from the
    page cache (same as mmapFile demand paging),
  * lazy per-genome loading (Alignment._loader),
  * trivially sharded: each array is its own file, so a multi-host job can
    fetch only the genomes/columns it needs,
  * a 'dirty' flag in the manifest written during updates mirrors the mmap
    header's dirty bit for crash detection (mmapFile.h:30,36-40).
"""

from __future__ import annotations

import json
import os

import numpy as np

from hal_tpu.constants import HAL_VERSION
from hal_tpu.alignment import Alignment
from hal_tpu.genome import GenomeArrays
from hal_tpu.tree import Tree

MANIFEST = "halz.json"
FORMAT_VERSION = 1

_ARRAYS = (
    "seq_start", "seq_top", "seq_bot",
    "top_start", "top_parent", "top_parent_reversed", "top_bottom_parse", "top_paralogy",
    "bot_start", "bot_top_parse", "bot_child", "bot_child_reversed",
    "dna",
)


def _genome_dir(path: str, name: str) -> str:
    # genome names are filesystem-safe in practice; escape path separators
    return os.path.join(path, name.replace("/", "%2F"))


def save(aln: Alignment, path: str, mmap_ok: bool = True) -> None:
    os.makedirs(path, exist_ok=True)
    manifest = {
        "format": "halz",
        "format_version": FORMAT_VERSION,
        "hal_version": aln.version or HAL_VERSION,
        "dirty": True,
        "tree": aln.get_newick_tree(),
        "metadata": aln.metadata,
        "genomes": {},
    }
    mpath = os.path.join(path, MANIFEST)
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    for name in aln.genome_names():
        g = aln.open_genome(name)
        gd = _genome_dir(path, name)
        os.makedirs(gd, exist_ok=True)
        for arr in _ARRAYS:
            np.save(os.path.join(gd, arr + ".npy"), getattr(g, arr))
        manifest["genomes"][name] = {
            "seq_names": g.seq_names,
            "metadata": g.metadata,
            "length": g.length,
            "n_top": g.num_top_segments,
            "n_bot": g.num_bottom_segments,
            "n_children": g.num_children,
        }
    manifest["dirty"] = False
    with open(mpath, "w") as fh:
        json.dump(manifest, fh, indent=1)


def load(path: str, mmap: bool = True) -> Alignment:
    with open(os.path.join(path, MANIFEST)) as fh:
        manifest = json.load(fh)
    if manifest.get("dirty"):
        raise IOError("halz alignment %s is marked dirty (crashed writer?)" % path)
    aln = Alignment(path=path)
    aln.version = manifest.get("hal_version", HAL_VERSION)
    aln.metadata = dict(manifest.get("metadata", {}))
    tree_str = manifest.get("tree", "")
    aln.tree = Tree.from_newick(tree_str) if tree_str else Tree()

    genomes_meta = manifest.get("genomes", {})

    def loader(name: str) -> GenomeArrays:
        gd = _genome_dir(path, name)
        g = GenomeArrays(name=name)
        mode = "r" if mmap else None
        for arr in _ARRAYS:
            a = np.load(os.path.join(gd, arr + ".npy"), mmap_mode=mode)
            setattr(g, arr, a)
        gm = genomes_meta.get(name, {})
        g.seq_names = list(gm.get("seq_names", []))
        g.metadata = dict(gm.get("metadata", {}))
        return g

    aln._loader = loader
    return aln
