"""genome_tpu — a de novo genome assembler built from scratch in JAX/XLA,
with the capabilities of the Scala reference ``winger/genome``.

Reference parity contract: see SEMANTICS.md at the repo root. The
pipeline shape (k-mer extraction → counting → de Bruijn graph → tip
clipping / bubble popping / unitig compaction → contigs, with a
hash-partitioned distributed k-mer space mirroring
``DNAMap``/``PartitionedDNAMap``) follows SURVEY.md §1-§3.

Layers (SURVEY.md §1.2):
  io/       T0: FASTA/FASTQ streaming + 2-bit packed read batches (host)
  kernels/  T1: jitted device kernels (extract, count, compaction)
  graph/    T2: de Bruijn graph build + simplification under jit
  dist/     T3: hash-sharded k-mer space over a device mesh (shard_map)
  assemble/ T4: pipeline driver, CLI, checkpointing, metrics
  golden/   T5: NumPy golden reference + pure-Python tiny oracle
"""

from genome_tpu.params import AssemblyParams

__version__ = "0.1.0"

__all__ = ["AssemblyParams", "__version__"]
