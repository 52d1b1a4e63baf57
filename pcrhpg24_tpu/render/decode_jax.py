"""JAX decoder for the reference `.huffman` batch streams (XLA path).

Vectorizes the GPU warp decoder (reference: modules/huffman_mem_iter_cuda/
render.cu:398-451) over all batches x 1024 lanes at once: the per-warp
ballot refill becomes a 32-lane segment prefix-sum, the shared-memory
table lookup becomes a gather into per-batch 4096-entry tables, and the
sequential 64-point x 3-component loop becomes a `lax.scan`.

This path is bit-exact with the CPU codec and works on any backend; the
flagship's native `.tpc` layout (render/methods/huffman_tpu.py) is the
performance path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    MAX_CW_LEN,
    POINTS_PER_THREAD,
    WARP_SIZE,
    WARPS_PER_BATCH,
    WORKGROUP_SIZE,
)


def _gather(arr, idx):
    return jnp.take(arr, idx, mode="clip")


def decode_batches_core(
    encoding,  # (E,) u32 flat
    enc_offsets,  # (B,) i32 batch encoding start
    cluster_sizes,  # (B, 32) i32 inclusive prefix word counts
    separate,  # (S,) i32 flat
    sep_offsets,  # (B,) i32 batch separate start
    separate_sizes,  # (B, 1024) i32 inclusive prefix counts
    table_values,  # (B, 4096) i32
    table_cw_len,  # (B, 4096) i32
    start_values,  # (B, 1024, 3) i32
    points_per_thread: int = POINTS_PER_THREAD,
):
    """Decode -> (B, 1024, points_per_thread, 3) i32 absolute grid coords."""
    B = enc_offsets.shape[0]
    L = WORKGROUP_SIZE

    encoding = jnp.concatenate(
        [encoding.astype(jnp.uint32), jnp.zeros(2 * WARP_SIZE, jnp.uint32)]
    )
    separate = (
        jnp.concatenate([separate.astype(jnp.int32), jnp.zeros(1, jnp.int32)])
        if separate.shape[0] > 0
        else jnp.zeros(1, jnp.int32)
    )
    tv = table_values.reshape(-1)
    tl = table_cw_len.reshape(-1)

    # per-lane stream base: batch offset + warp cluster offset
    warp_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), cluster_sizes[:, :-1].astype(jnp.int32)], axis=1
    )  # (B,32) exclusive
    lane_warp = jnp.arange(L) // WARP_SIZE
    base = enc_offsets[:, None].astype(jnp.int32) + warp_prev[:, lane_warp]  # (B,L)

    lane_in_warp = (jnp.arange(L) % WARP_SIZE)[None, :]
    cur = _gather(encoding, base + lane_in_warp)
    nxt = _gather(encoding, base + WARP_SIZE + lane_in_warp)
    cur_bits = jnp.full((B, L), 32, jnp.int32)
    already = jnp.full((B, WARPS_PER_BATCH), 2 * WARP_SIZE, jnp.int32)

    sep_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), separate_sizes[:, :-1].astype(jnp.int32)], axis=1
    )
    sep_ptr = sep_offsets[:, None].astype(jnp.int32) + sep_prev  # (B,L)

    prev = start_values.astype(jnp.int32)  # (B,L,3)
    batch_tab_base = (jnp.arange(B) * table_values.shape[1])[:, None]  # (B,1)

    mask_shift = jnp.uint32(32 - MAX_CW_LEN)

    def decode_symbol(state):
        cur, nxt, cur_bits, already, sep_ptr = state
        cb = jnp.clip(cur_bits, 1, 31).astype(jnp.uint32)  # shift-safe
        L_ = jnp.where(cur_bits == 32, cur, cur << (jnp.uint32(32) - cb))
        R_ = jnp.where(cur_bits == 32, jnp.uint32(0), nxt >> cb)
        key = ((L_ | R_) >> mask_shift).astype(jnp.int32)
        tidx = batch_tab_base + key
        slen = _gather(tl, tidx)
        lit = slen > 0
        sym = jnp.where(lit, _gather(tv, tidx), _gather(separate, sep_ptr))
        sep_ptr = sep_ptr + (~lit)
        cur_bits = cur_bits - jnp.abs(slen)

        need = cur_bits <= 0
        per_warp = need.reshape(B, WARPS_PER_BATCH, WARP_SIZE)
        offs = jnp.cumsum(per_warp, axis=2) - per_warp  # exclusive prefix
        ridx = (
            base.reshape(B, WARPS_PER_BATCH, WARP_SIZE)
            + already[:, :, None]
            + offs
        ).reshape(B, L)
        refill = _gather(encoding, ridx)
        cur = jnp.where(need, nxt, cur)
        nxt = jnp.where(need, refill, nxt)
        cur_bits = jnp.where(need, cur_bits + 32, cur_bits)
        already = already + per_warp.sum(axis=2, dtype=jnp.int32)
        return (cur, nxt, cur_bits, already, sep_ptr), sym

    def point_step(carry, _):
        state, prev = carry
        deltas = []
        for _j in range(3):
            state, sym = decode_symbol(state)
            deltas.append(sym)
        d = jnp.stack(deltas, axis=-1)  # (B,L,3)
        prev = prev + d
        return (state, prev), prev

    init = ((cur, nxt, cur_bits, already, sep_ptr), prev)
    _, coords = jax.lax.scan(point_step, init, None, length=points_per_thread)
    # (P, B, L, 3) -> (B, L, P, 3)
    return jnp.transpose(coords, (1, 2, 0, 3))


decode_batches = jax.jit(decode_batches_core, static_argnames=("points_per_thread",))


def batches_to_device(dumps):
    """Pack a list of BatchDump into the flat device arrays of decode_batches.

    Mirrors HuffmanLasData's append-cursor upload scheme
    (HuffmanLasLoader.cpp:176-299).  Returns a dict of np arrays.
    """
    B = len(dumps)
    enc_offsets = np.zeros(B, np.int32)
    sep_offsets = np.zeros(B, np.int32)
    enc_parts, sep_parts = [], []
    cluster_sizes = np.zeros((B, WARPS_PER_BATCH), np.int32)
    separate_sizes = np.zeros((B, WORKGROUP_SIZE), np.int32)
    table_values = np.zeros((B, 4096), np.int32)
    table_cw_len = np.zeros((B, 4096), np.int32)
    start_values = np.zeros((B, WORKGROUP_SIZE, 3), np.int32)
    colors = []
    scales = np.zeros((B, 3))
    offsets = np.zeros((B, 3))
    bbox_min = np.zeros((B, 3), np.float32)
    bbox_max = np.zeros((B, 3), np.float32)
    las_min = np.zeros((B, 3), np.float32)

    e = s = 0
    for i, b in enumerate(dumps):
        enc_offsets[i] = e
        sep_offsets[i] = s
        enc_parts.append(np.asarray(b.encoding, np.uint32))
        sep_parts.append(np.asarray(b.separate, np.int32))
        e += len(b.encoding)
        s += len(b.separate)
        cluster_sizes[i] = b.cluster_sizes
        separate_sizes[i] = b.separate_sizes
        table_values[i] = b.decoder_values
        table_cw_len[i] = b.decoder_cw_len
        start_values[i] = np.asarray(b.start_values).reshape(WORKGROUP_SIZE, 3)
        colors.append(np.asarray(b.color, np.uint32))
        scales[i] = b.las_scale
        offsets[i] = b.las_offset
        bbox_min[i] = b.bbox_min
        bbox_max[i] = b.bbox_max
        las_min[i] = b.las_min

    return dict(
        encoding=np.concatenate(enc_parts) if enc_parts else np.zeros(0, np.uint32),
        enc_offsets=enc_offsets,
        cluster_sizes=cluster_sizes,
        separate=np.concatenate(sep_parts) if sep_parts else np.zeros(0, np.int32),
        sep_offsets=sep_offsets,
        separate_sizes=separate_sizes,
        table_values=table_values,
        table_cw_len=table_cw_len,
        start_values=start_values,
        colors=np.stack(colors),
        scale=scales,
        offset=offsets,
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        las_min=las_min,
    )
