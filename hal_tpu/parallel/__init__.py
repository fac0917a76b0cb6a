"""Multi-device scaling: jax.sharding over device meshes.

Replaces the reference's process-pool scaling (multiprocessing over CLI
subprocesses, stats/halStats.py:33-48; coordinate slicing hal2mafMP.py:63-80)
with SPMD: query intervals are data-parallel across devices, coverage/depth
accumulators are sharded over the coordinate axis, and results merge with
XLA collectives (psum / reduce_scatter) instead of a shared
filesystem."""
