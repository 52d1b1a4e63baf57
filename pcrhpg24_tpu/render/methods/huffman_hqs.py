"""`huffman_hqs` — high-quality shading on compressed data.

Replicates the reference's three-pass HQS method (reference:
modules/huffman_hqs/): a depth prepass builds the per-pixel minimum
depth, a color pass re-decodes every batch and accumulates r/g/b/count
sums for fragments within 1% of the minimum depth
(render.cu:296 `pos.w <= oldDepth * 1.01`), and a resolve divides.

Here the u64 atomicAdd RG/BA accumulators (render.cu:311-313)
become u32 scatter-adds per channel; unlike min-scatter, adds commute
across chunks so chunked accumulation needs no merge trick.  Both passes
decode (the reference also decodes twice).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import POINTS_PER_THREAD, WORKGROUP_SIZE
from ...engine.debug import Debug
from ...engine.method import Method, Runtime
from ..bc1_layout import bc1_payload_reference
from ..decode_jax import decode_batches_core
from ..raster import EMPTY, hqs_accumulate, project, resolve_hqs
from .huffman_mem_iter import CHUNK, HuffmanMemIter, _slice_rows


def _project_points(dev, chunk_start, transform, lod_n, scale, offset_rel,
                    width, height):
    """Decode a chunk and project -> (pid, depth_bits, w, payload_colors, ok)."""
    enc_offsets = _slice_rows(dev["enc_offsets"], chunk_start, CHUNK)
    cluster_sizes = _slice_rows(dev["cluster_sizes"], chunk_start, CHUNK)
    sep_offsets = _slice_rows(dev["sep_offsets"], chunk_start, CHUNK)
    separate_sizes = _slice_rows(dev["separate_sizes"], chunk_start, CHUNK)
    table_values = _slice_rows(dev["table_values"], chunk_start, CHUNK)
    table_cw_len = _slice_rows(dev["table_cw_len"], chunk_start, CHUNK)
    start_values = _slice_rows(dev["start_values"], chunk_start, CHUNK)
    colors = _slice_rows(dev["colors"], chunk_start, CHUNK)
    n_chunk = _slice_rows(lod_n, chunk_start, CHUNK)

    coords = decode_batches_core(
        dev["encoding"], enc_offsets, cluster_sizes, dev["separate"],
        sep_offsets, separate_sizes, table_values, table_cw_len, start_values,
    )
    pos = (coords.astype(jnp.float32) * scale + offset_rel).reshape(-1, 3)

    pt_idx = jnp.arange(POINTS_PER_THREAD, dtype=jnp.int32)
    mask = jnp.broadcast_to(
        pt_idx[None, None, :] < n_chunk[:, None, None], coords.shape[:3]
    ).reshape(-1)
    rgba = bc1_payload_reference(colors, coords.shape[:3]).reshape(-1)

    clip = project(pos, transform)
    w = clip[:, 3]
    ndc_x = clip[:, 0] / w
    ndc_y = clip[:, 1] / w
    ok = mask & (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    px = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    py = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pid = jnp.where(ok, px + py * width, width * height)
    return pid, w, rgba, ok


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(6,))
def depth_chunk(dev, chunk_start, transform, lod_n, scale, offset_rel,
                fb_depth, width: int, height: int):
    pid, w, _rgba, _ok = _project_points(
        dev, chunk_start, transform, lod_n, scale, offset_rel, width, height
    )
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)
    return fb_depth.at[pid].min(depth, mode="drop")


@partial(
    jax.jit, static_argnames=("width", "height"), donate_argnums=(7, 8, 9, 10)
)
def accumulate_chunk(dev, chunk_start, transform, lod_n, scale, offset_rel,
                     fb_depth, acc_r, acc_g, acc_b, acc_n,
                     width: int, height: int):
    pid, w, rgba, _ok = _project_points(
        dev, chunk_start, transform, lod_n, scale, offset_rel, width, height
    )
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)
    return hqs_accumulate((acc_r, acc_g, acc_b, acc_n), pid, depth, rgba,
                          fb_depth)


class HuffmanHQS(HuffmanMemIter):
    """Three-pass HQS wrapper (huffman_hqs.h:126-273)."""

    def __init__(self, renderer, las):
        super().__init__(renderer, las)
        self.name = "huffman_hqs"
        self.description = "HQS: depth prepass + tolerance-blended average"

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        B = las.num_batches_loaded
        if B == 0 or las.scale is None:
            return jnp.full((H, W), jnp.uint32(0x00443322))

        wvp, lod_full = self.frame_setup(renderer)
        lod_dev = jnp.asarray(lod_full)
        scale = jnp.asarray(las.scale, jnp.float32)
        offset_rel = jnp.asarray(las.offset - las.las_min, jnp.float32)
        t = jnp.asarray(wvp)

        size = W * H
        fb_depth = jnp.full((size,), EMPTY, jnp.uint32)
        nchunks = (B + CHUNK - 1) // CHUNK
        for c in range(nchunks):
            fb_depth = depth_chunk(
                las.dev, c * CHUNK, t, lod_dev, scale, offset_rel, fb_depth, W, H
            )
        acc = [jnp.zeros((size,), jnp.uint32) for _ in range(4)]
        for c in range(nchunks):
            acc = list(
                accumulate_chunk(
                    las.dev, c * CHUNK, t, lod_dev, scale, offset_rel,
                    fb_depth, *acc, W, H
                )
            )
        renderer.last_fb = (fb_depth, acc[3])
        return resolve_hqs(*acc, W, H)
