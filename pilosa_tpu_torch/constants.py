"""Layout constants of the bitmap index, and the kernel families.

Trimmed copy of pilosa_tpu/constants.py:13-45: the on-disk and in-memory
layout must stay identical to the reference, so that the port opens the
fragments the JAX package writes and the reverse. KERNEL_FAMILY_REPS is
the JAX package's table (:54-71), so both servers label /metrics alike.
"""

# Row r of shard s covers absolute bit positions [r * SHARD_WIDTH,
# (r+1) * SHARD_WIDTH).
SHARD_WIDTH_EXP = 20
SHARD_WIDTH = 1 << SHARD_WIDTH_EXP  # 1,048,576 columns

# Dense device layout: 32-bit words, little-endian bit order within a word.
# Bit position p lives at word p >> 5, bit p & 31.
WORD_BITS = 32
WORDS_PER_SHARD = SHARD_WIDTH // WORD_BITS  # 32,768 words = 128 KiB

# Roaring container geometry.
CONTAINER_BITS = 1 << 16
CONTAINERS_PER_SHARD = SHARD_WIDTH // CONTAINER_BITS  # 16
ARRAY_MAX_SIZE = 4096   # array container -> bitmap container threshold

# Fragment write-ahead behaviour: ops before snapshot compaction.
MAX_OP_N = 2000

# Field option default.
DEFAULT_CACHE_SIZE = 50000

# Name of the per-index existence field.
EXISTENCE_FIELD_NAME = "_exists"

# On-disk roaring format magic.
MAGIC_NUMBER = 12348
STORAGE_VERSION = 0

# Kernel families and the device representation each operates on: the
# label space of the pilosa_kernels* metric families (utils/telemetry.py
# KernelStats). The port's launches map onto it as follows: the eight
# hand kernels of ops/kernels.py -> "pallas" (their TPU twins' family);
# the sparse and run steps of ops/hybrid.py -> "sparse" / "run"; the write
# path's leaf patches -> "ingest"; the plain-torch TopN ranking and BSI
# descents -> "topn" / "bsi"; the batchers' queue wait -> "batcher".
KERNEL_FAMILY_REPS = {
    "pallas": "dense",
    "topn": "dense",
    "bsi": "dense",
    "bitwise": "dense",
    "count": "dense",
    "groupby": "dense",
    "sparse": "sparse",
    "run": "run",
    "ingest": "dense",
    "program": "dense",
    "stream": "dense",
    "batcher": "dense",
    "ici_program": "dense",
    "stream_mesh": "dense",
    "groupby_mesh": "dense",
}
KERNEL_FAMILIES = frozenset(KERNEL_FAMILY_REPS)
