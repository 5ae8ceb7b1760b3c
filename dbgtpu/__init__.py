"""dbgtpu — de Bruijn graph read mapper in JAX, run on a GPU.

A from-scratch JAX/XLA re-design of the capabilities of BGREAT
(Malfoy/BGREAT, C++): mapping short reads onto a compacted de Bruijn
graph given as a unitig FASTA (BCALM2 style), reporting each read as a
path of signed unitig IDs.

Architecture (nothing here is a translation of the C++):
  - strings exist only at the I/O edge; on device everything is 2-bit
    codes in fixed-shape int arrays,
  - the junction index is an exact open-addressing hash table (the
    reference's MPHF + stored-key verification has exact-dictionary
    semantics, see reference aligner.cpp:147-267), built host-side and
    queried with a fixed-probe vectorized loop on device,
  - the recursive greedy extension (reference alignerGreedy.cpp) becomes
    a batched `lax.while_loop` state machine over a read batch; the
    per-junction candidate choice is an argmin with earliest-index
    tie-break (provably equivalent to the reference's first-exact-match
    short-circuit + strict-minimum update),
  - scaling is data-parallel over reads via `shard_map` on a device
    Mesh, with `psum` for statistics; the index is replicated (it is
    read-only, like the reference's shared-memory index) or, with
    --shard-index, bucket-range-sharded over the mesh.
"""

__version__ = "0.1.0"
