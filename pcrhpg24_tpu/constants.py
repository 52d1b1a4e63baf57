"""Global layout constants of the batch format.

Mirrors the reference's compile-time constants (reference:
modules/compute/Resources.h:4-15) so that `.huffman` files are
interchangeable between the CUDA reference and this framework.
"""

# Points decoded by one chain (one CUDA thread in the reference).
POINTS_PER_THREAD = 64
# Outer loop multiplier; kept at 1 in the reference's main path.
CLUSTERS_PER_THREAD = 1
# Chains per batch (threads per workgroup in the reference).
WORKGROUP_SIZE = 1024
# Points per batch: one batch == one CUDA block in the reference.
POINTS_PER_WORKGROUP = WORKGROUP_SIZE * POINTS_PER_THREAD  # 65 536
# Points per preprocessing/IO chunk (100 batches).
MAX_POINTS_PER_BATCH = 100 * POINTS_PER_WORKGROUP  # 6 553 600
# Decoder-table entries => max codeword length 12 bits.
HUFFMAN_TABLE_SIZE = 4096
MAX_CW_LEN = 12  # log2(HUFFMAN_TABLE_SIZE)
# Warp width of the reference's interleaved encoding stream.
WARP_SIZE = 32
WARPS_PER_BATCH = WORKGROUP_SIZE // WARP_SIZE  # 32
# Color compression: 0 = raw RGBA8, 1 = BC1, 7 = BC7 mode 6.
COLOR_COMPRESSION = 1

# ---- `.tpc` native format constants (on-disk layout; names kept) ----
# Lane-group width of the native stream interleave.
TPU_GROUP_SIZE = 128
TPU_GROUPS_PER_BATCH = WORKGROUP_SIZE // TPU_GROUP_SIZE  # 8
# Max symbol-code length of the canonical bucket-Huffman code.
TPU_MAX_CODE_LEN = 12
# Bucket count: bit-length of zigzag(delta) in [0, 32].
TPU_NUM_BUCKETS = 33

# Batches per fused render pass (bounds decode working-set memory).
RENDER_CHUNK_BATCHES = 256
