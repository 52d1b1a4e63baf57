"""Whole-batch encode/decode of the `.huffman` geometry stream, vectorized.

A batch is 65 536 Morton-sorted points split into 1024 chains of 64
(reference: src/preprocess.cpp:202-227).  Per chain the coordinates are
delta-encoded against the previous point with the first point as start
value (preprocess.cpp:318-329), deltas interleaved x0 y0 z0 x1 y1 z1 ...
(preprocess.cpp:331-343), Huffman-coded with one per-batch clipped
dictionary (preprocess.cpp:757-776), and the 32 chains of each warp are
word-interleaved in GPU consumption order (preprocess.cpp:540-587).

This module is the NumPy-vectorized implementation used by the
preprocessor and by tests; the JAX decoders mirror its semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    MAX_CW_LEN,
    POINTS_PER_THREAD,
    WARP_SIZE,
    WARPS_PER_BATCH,
    WORKGROUP_SIZE,
)
from .huffman import build_pjn_dictionary

U32 = np.uint32
I32 = np.int32
SYMS_PER_LANE = POINTS_PER_THREAD * 3  # 192


@dataclass
class EncodedBatch:
    """Geometry payload of one batch (arrays as serialized on disk)."""

    start_values: np.ndarray  # (1024*3,) i32 — first xyz per chain
    encoding: np.ndarray  # (W,) u32 — 32 interleaved warp streams
    separate: np.ndarray  # (S,) i32 — escape values, chain-major
    separate_sizes: np.ndarray  # (1024,) i32 — inclusive prefix counts
    decoder_values: np.ndarray  # (4096,) i32
    decoder_cw_len: np.ndarray  # (4096,) i32 signed
    cluster_sizes: np.ndarray  # (32,) i32 — inclusive prefix word counts
    bbox_min_i: np.ndarray  # (3,) i32 int-coord bbox
    bbox_max_i: np.ndarray  # (3,) i32


def chain_deltas(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """(65536,) coords -> (1024,192) interleaved deltas + (1024,3) starts."""
    pts = np.stack([x, y, z], axis=-1).astype(np.int64).reshape(WORKGROUP_SIZE, POINTS_PER_THREAD, 3)
    deltas = np.zeros_like(pts)
    deltas[:, 1:] = pts[:, 1:] - pts[:, :-1]
    # int32 wraparound semantics
    deltas = deltas.astype(np.int64)
    deltas = ((deltas + 2**31) % 2**32 - 2**31).astype(I32)
    starts = pts[:, 0, :].astype(I32)
    return deltas.reshape(WORKGROUP_SIZE, SYMS_PER_LANE), starts


def _pack_lane_bits(codes, bits, lane_total_bits):
    """Vectorized MSB-first packing of per-lane codeword streams.

    codes/bits: (1024, 192) u32/i32.  Returns (words (1024, maxW) u32,
    n_words (1024,), w0 (1024,192) start word of each symbol).
    """
    csum = np.cumsum(bits, axis=1)
    start = csum - bits  # start bit of each symbol
    n_words = (lane_total_bits + 31) // 32
    max_w = int(n_words.max())
    words = np.zeros((WORKGROUP_SIZE, max_w + 1), np.uint64)

    w0 = start // 32
    sh = 32 - (start % 32) - bits
    c64 = codes.astype(np.uint64)
    part0 = np.where(sh >= 0, c64 << np.maximum(sh, 0).astype(np.uint64),
                     c64 >> (-np.minimum(sh, 0)).astype(np.uint64)) & 0xFFFFFFFF
    part1 = np.where(sh < 0, (c64 << (32 + np.minimum(sh, 0)).astype(np.uint64)) & 0xFFFFFFFF, 0)

    lane_idx = np.broadcast_to(np.arange(WORKGROUP_SIZE)[:, None], w0.shape)
    np.bitwise_or.at(words, (lane_idx, w0), part0)
    span = sh < 0
    np.bitwise_or.at(words, (lane_idx[span], w0[span] + 1), part1[span])
    return words[:, :max_w].astype(U32), n_words, w0


def encode_batch(x, y, z) -> EncodedBatch:
    deltas, starts = chain_deltas(x, y, z)
    flat = deltas.reshape(-1)

    d = build_pjn_dictionary(flat)
    tv, tl = d.table()

    # map symbols -> (code, signed len) via sorted lookup
    keys = np.array(sorted(d.codes.keys()), np.int64)
    code_arr = np.array([d.codes[int(k)][0] for k in keys], np.uint32)
    len_arr = np.array([d.codes[int(k)][1] for k in keys], np.int64)

    # fast path: byte-identical C++ core (pcrhpg24_tpu/native)
    from .. import native as _ncore

    if _ncore.available():
        enc, sep, sep_sizes, cluster = _ncore.encode_ref_batch_streams(
            deltas.astype(np.int32), keys.astype(np.int32), code_arr,
            len_arr.astype(np.int32),
        )
        bbox_min = np.array([x.min(), y.min(), z.min()], I32)
        bbox_max = np.array([x.max(), y.max(), z.max()], I32)
        return EncodedBatch(
            start_values=starts.reshape(-1).astype(I32),
            encoding=enc,
            separate=sep,
            separate_sizes=sep_sizes,
            decoder_values=tv.astype(I32),
            decoder_cw_len=tl.astype(I32),
            cluster_sizes=cluster,
            bbox_min_i=bbox_min,
            bbox_max_i=bbox_max,
        )

    pos = np.searchsorted(keys, deltas.astype(np.int64))
    codes = code_arr[pos]
    slen = len_arr[pos]
    bits = np.abs(slen).astype(np.int64)

    lane_bits = bits.sum(axis=1)
    words, n_words, w0 = _pack_lane_bits(codes, bits, lane_bits)

    # escapes, chain-major order
    esc = slen < 0
    separate = deltas[esc].astype(I32)
    sep_counts = esc.sum(axis=1)
    separate_sizes = np.cumsum(sep_counts).astype(I32)  # inclusive

    # per-warp protocol-exact interleave (see warp_interleave.py docstring)
    csum = np.cumsum(bits, axis=1)
    encoding_parts = []
    cluster_sizes = np.empty(WARPS_PER_BATCH, I32)
    for wid in range(WARPS_PER_BATCH):
        sel = slice(wid * WARP_SIZE, (wid + 1) * WARP_SIZE)
        packed = _interleave_warp_fast(words[sel], n_words[sel], csum[sel])
        cluster_sizes[wid] = len(packed)
        encoding_parts.append(packed)
    encoding = np.concatenate(encoding_parts).astype(U32)
    cluster_sizes = np.cumsum(cluster_sizes).astype(I32)

    bbox_min = np.array([x.min(), y.min(), z.min()], I32)
    bbox_max = np.array([x.max(), y.max(), z.max()], I32)
    return EncodedBatch(
        start_values=starts.reshape(-1).astype(I32),
        encoding=encoding,
        separate=separate,
        separate_sizes=separate_sizes,
        decoder_values=tv.astype(I32),
        decoder_cw_len=tl.astype(I32),
        cluster_sizes=cluster_sizes,
        bbox_min_i=bbox_min,
        bbox_max_i=bbox_max,
    )


def _interleave_warp_fast(words, n_words, bit_csum):
    """Vectorized protocol-exact warp interleave.

    words: (32, maxW) u32, n_words: (32,), bit_csum: (32, 192) cumulative
    bits per symbol.  Requests: lane t's word j+1 is loaded when the
    decoder crosses bit boundary 32*j (j >= 1); boundaries up to
    floor(total/32) fire (incl. 1-2 phantoms past the real stream).
    """
    reqs_key = []
    reqs_tid = []
    reqs_widx = []
    for t in range(WARP_SIZE):
        total = int(bit_csum[t, -1])
        n_req = total // 32
        trig = np.searchsorted(bit_csum[t], 32 * np.arange(1, n_req + 1))
        reqs_key.append(trig + 1)
        reqs_tid.append(np.full(n_req, t))
        reqs_widx.append(np.arange(2, n_req + 2))
    key = np.concatenate(reqs_key)
    tid = np.concatenate(reqs_tid)
    widx = np.concatenate(reqs_widx)
    order = np.lexsort((widx, tid, key))

    head = np.empty(2 * WARP_SIZE, U32)
    head[:WARP_SIZE] = words[:, 0]
    head[WARP_SIZE:] = words[:, 1]

    t_s, w_s = tid[order], widx[order]
    real = w_s < n_words[t_s]
    tail = np.where(real, words[np.minimum(t_s, 31), np.minimum(w_s, words.shape[1] - 1)], 0)
    tail[~real] = 0
    return np.concatenate([head, tail.astype(U32)])


def decode_batch(
    encoding: np.ndarray,
    cluster_sizes: np.ndarray,
    separate: np.ndarray,
    separate_sizes: np.ndarray,
    table_values: np.ndarray,
    table_cw_len: np.ndarray,
    num_symbols: int = SYMS_PER_LANE,
) -> np.ndarray:
    """Decode all 1024 lanes of a batch; mirror of render.cu:398-451.

    Returns (1024, num_symbols) i32 interleaved deltas.
    """
    max_cw = MAX_CW_LEN
    shift = 32 - max_cw

    warp_base = np.zeros(WARPS_PER_BATCH, np.int64)
    warp_base[1:] = np.asarray(cluster_sizes[:-1], np.int64)
    lane_warp = np.arange(WORKGROUP_SIZE) // WARP_SIZE

    stream = np.concatenate(
        [np.asarray(encoding, U32), np.zeros(2 * WARP_SIZE, U32)]
    ).astype(np.uint64)

    lane_in_warp = np.arange(WORKGROUP_SIZE) % WARP_SIZE
    base = warp_base[lane_warp]
    cur = stream[base + lane_in_warp].copy()
    nxt = stream[base + WARP_SIZE + lane_in_warp].copy()
    already = np.full(WARPS_PER_BATCH, 2 * WARP_SIZE, np.int64)
    cur_bits = np.full(WORKGROUP_SIZE, 32, np.int64)

    sep_ptr = np.zeros(WORKGROUP_SIZE, np.int64)
    sep_ptr[1:] = np.asarray(separate_sizes[:-1], np.int64)
    sep = np.asarray(separate, I32)
    if sep.size == 0:
        sep = np.zeros(1, I32)

    tv = np.asarray(table_values, I32)
    tl = np.asarray(table_cw_len, I32)

    out = np.empty((WORKGROUP_SIZE, num_symbols), I32)
    for i in range(num_symbols):
        lsh = (32 - cur_bits).astype(np.uint64)
        rsh = np.maximum(cur_bits, 1).astype(np.uint64)
        L = np.where(cur_bits == 32, cur, (cur << lsh) & 0xFFFFFFFF)
        R = np.where(cur_bits == 32, 0, nxt >> rsh)
        kidx = (((L | R) & 0xFFFFFFFF) >> shift).astype(np.int64)
        slen = tl[kidx]
        lit = slen > 0
        out[:, i] = np.where(lit, tv[kidx], sep[np.minimum(sep_ptr, sep.size - 1)])
        sep_ptr += ~lit
        cur_bits -= np.abs(slen)

        need = cur_bits <= 0
        if need.any():
            per_warp = need.reshape(WARPS_PER_BATCH, WARP_SIZE)
            offs = np.cumsum(per_warp, axis=1) - per_warp  # exclusive
            idx = (base.reshape(WARPS_PER_BATCH, WARP_SIZE)
                   + already[:, None] + offs).reshape(-1)
            refill = stream[np.minimum(idx, len(stream) - 1)]
            cur = np.where(need, nxt, cur)
            nxt = np.where(need, refill, nxt)
            cur_bits = np.where(need, cur_bits + 32, cur_bits)
            already += per_warp.sum(axis=1)
    return out


def deltas_to_coords(deltas: np.ndarray, start_values: np.ndarray):
    """(1024,192) interleaved deltas + (1024*3,) starts -> (65536,3) i32."""
    d = deltas.reshape(WORKGROUP_SIZE, POINTS_PER_THREAD, 3).astype(np.int64)
    s = np.asarray(start_values, np.int64).reshape(WORKGROUP_SIZE, 1, 3)
    # delta[0] == 0 and cur = prev + delta starting from start value
    coords = s + np.cumsum(d, axis=1)
    coords = (coords + 2**31) % 2**32 - 2**31
    return coords.reshape(-1, 3).astype(I32)
