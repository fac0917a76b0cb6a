"""hal_tpu — an accelerator-native hierarchical genome-alignment query engine.

A from-scratch re-design of the capabilities of ComparativeGenomicsToolkit/hal
for accelerators driven through JAX (its device path runs on an NVIDIA GPU):

* genomes are flat columnar (structure-of-arrays) segment arrays instead of an
  HDF5/mmap object graph (reference: api/hdf5_impl/, api/mmap_impl/),
* liftover / column extraction / alignment depth are batched gather+scan
  traversals over the phylogenetic tree in JAX (reference: recursive C++
  pointer-chasing in api/impl/halSegmentMapper.cpp, halColumnIterator.cpp),
* scaling is jax.sharding over device meshes instead of multiprocessing
  pools shelling out to CLI binaries (reference: stats/halStats.py:33-48).

Public surface mirrors the reference's libHal API (api/inc/hal.h) at the
level of capabilities, not classes.
"""

from hal_tpu.constants import NULL_INDEX, HAL_VERSION
from hal_tpu.tree import Tree
from hal_tpu.genome import GenomeArrays, SequenceInfo
from hal_tpu.alignment import Alignment

__version__ = "0.1.0"

__all__ = [
    "NULL_INDEX",
    "HAL_VERSION",
    "Tree",
    "GenomeArrays",
    "SequenceInfo",
    "Alignment",
    "open_alignment",
]


def open_alignment(path, mode="r"):
    """Open a HAL alignment, auto-detecting the storage format.

    Mirrors openHalAlignment/detectHalAlignmentFormat
    (reference api/inc/halAlignmentInstance.h:83-111).
    """
    from hal_tpu.storage import open_alignment as _open

    return _open(path, mode)
