"""`huffman_mem_iter` — the flagship fused decode + rasterize method.

Replicates the behavior of the reference's flagship CUDA method
(reference: modules/huffman_mem_iter_cuda/): per frame, every loaded
batch is frustum-culled, assigned a screen-size LOD point budget,
Huffman-decoded, projected, and depth-tested into a (depth<<32|payload)
framebuffer, then resolved to an image.

Mapping:
* one CUDA block per batch        -> batch axis of the vectorized decoder
* warp ballot stream refill       -> 32-lane segment prefix sums
* u64 atomicMin framebuffer       -> per-chunk two-pass u32 scatter-min
                                     + dense lexicographic chunk merge
                                     (exact: each chunk's (depth,payload)
                                     pair is fully resolved before
                                     merging, so cross-chunk interleaving
                                     cannot flip winners)
* LOD early-exit loop trip count  -> static 64-point decode + point mask
  (render.cu:346-379 heuristic computed host-side per frame)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import POINTS_PER_THREAD, RENDER_CHUNK_BATCHES, WORKGROUP_SIZE
from ...engine.debug import Debug
from ...engine.method import Method, Runtime
from ..bc1_layout import bc1_payload_reference
from ..camera import batches_in_frustum, frustum_planes, lod_points_per_thread
from ..decode_jax import decode_batches_core
from ..raster import EMPTY, merge_u64_min, resolve

CHUNK = RENDER_CHUNK_BATCHES  # batches per device pass (16.7M points)


def _slice_rows(arr, start, n):
    return jax.lax.dynamic_slice_in_dim(arr, start, n, axis=0)


@partial(
    jax.jit,
    static_argnames=("width", "height", "mode"),
    donate_argnums=(9, 10),
)
def render_chunk(
    dev,  # dict of flat device buffers (see HuffmanLasData.dev)
    chunk_start,  # traced i32 batch index of chunk begin
    transform,  # (4,4) f32 worldViewProj
    lod_n,  # (B,) i32 points-per-thread budget (0 == culled)
    scale,  # (3,) f32
    offset_rel,  # (3,) f32 == las_offset - las_min (legacy; kept for LOD)
    width: int,
    height: int,
    mode: str,
    fb_d,
    fb_p,
    tb=None,  # (B, 4) f32 per-batch folded translations (batch-relative path)
):
    C = CHUNK
    enc_offsets = _slice_rows(dev["enc_offsets"], chunk_start, C)
    cluster_sizes = _slice_rows(dev["cluster_sizes"], chunk_start, C)
    sep_offsets = _slice_rows(dev["sep_offsets"], chunk_start, C)
    separate_sizes = _slice_rows(dev["separate_sizes"], chunk_start, C)
    table_values = _slice_rows(dev["table_values"], chunk_start, C)
    table_cw_len = _slice_rows(dev["table_cw_len"], chunk_start, C)
    start_values = _slice_rows(dev["start_values"], chunk_start, C)
    colors = _slice_rows(dev["colors"], chunk_start, C)
    n_chunk = _slice_rows(lod_n, chunk_start, C)  # (C,)

    coords = decode_batches_core(
        dev["encoding"], enc_offsets, cluster_sizes, dev["separate"],
        sep_offsets, separate_sizes, table_values, table_cw_len, start_values,
    )  # (C, 1024, 64, 3) i32

    if tb is not None:
        # batch-relative precision: the reference's f64 close-up path
        # (render.cu:459-461) — exact i32 offsets from a per-batch
        # anchor, anchor's world contribution folded into tb (f64 host)
        anchor = _slice_rows(dev["anchor"], chunk_start, C)  # (C, 3) i32
        pos = (coords - anchor[:, None, None, :]).astype(jnp.float32) * scale
    else:
        pos = coords.astype(jnp.float32) * scale + offset_rel  # (C,1024,64,3)

    # LOD point mask: thread-local index i < n_b (render.cu:428 loop bound)
    pt_idx = jnp.arange(POINTS_PER_THREAD, dtype=jnp.int32)
    mask = jnp.broadcast_to(
        pt_idx[None, None, :] < n_chunk[:, None, None], coords.shape[:3]
    )

    if mode == "colorize_chunks":
        payload = jnp.broadcast_to(
            (chunk_start + jnp.arange(C)).astype(jnp.uint32)[:, None, None],
            coords.shape[:3],
        )
    elif mode == "show_num_points":
        payload = jnp.broadcast_to(
            n_chunk.astype(jnp.uint32)[:, None, None], coords.shape[:3]
        )
    else:
        payload = bc1_payload_reference(colors, coords.shape[:3]).astype(jnp.uint32)

    size = width * height
    t = transform.astype(jnp.float32)
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]  # (C, 1024, 64)
    if tb is not None:
        tbc = _slice_rows(tb, chunk_start, C)
        add = lambda i: tbc[:, i][:, None, None]
    else:
        add = lambda i: t[i, 3]
    cx = t[0, 0] * x + t[0, 1] * y + t[0, 2] * z + add(0)
    cy = t[1, 0] * x + t[1, 1] * y + t[1, 2] * z + add(1)
    w = t[3, 0] * x + t[3, 1] * y + t[3, 2] * z + add(3)

    inv = 1.0 / w  # reciprocal-multiply, as render_chunk_native does
    ndc_x = (cx * inv).reshape(-1)
    ndc_y = (cy * inv).reshape(-1)
    w = w.reshape(-1)
    pay = payload.reshape(-1)
    m = mask.reshape(-1)
    ok = m & (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    px = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    py = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pid = jnp.where(ok, px + py * width, size)
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)

    return merge_u64_min(fb_d, fb_p, pid, depth, pay)


class HuffmanMemIter(Method):
    """Flagship method wrapper (huffman_mem_iter_cuda.h:24-255)."""

    def __init__(self, renderer, las):
        self.name = "huffman_mem_iter"
        self.description = "fused Huffman decode + rasterize (XLA path)"
        self.group = "huffman"
        self.las = las
        self.renderer = renderer

    def update(self, renderer):
        if Runtime.resource is not self.las:
            if Runtime.resource is not None:
                Runtime.resource.unload(renderer)
            self.las.load(renderer)
            Runtime.resource = self.las

    def frame_setup(self, renderer):
        """Host-side per-frame state: cull + LOD + matrices."""
        las = self.las
        W, H = renderer.width, renderer.height
        cam = renderer.camera
        view = cam.view()
        proj = cam.proj()
        wvp = (proj @ view).astype(np.float32)
        B = las.num_batches_loaded

        # resource bboxes are stored in the render frame (world - las_min)
        bmin = las.bbox_min[:B]
        bmax = las.bbox_max[:B]
        if Debug.frustum_culling_enabled and Debug.update_frustum:
            planes = frustum_planes(proj @ view)
            vis = batches_in_frustum(planes, bmin, bmax)
        else:
            vis = np.ones(B, bool)
        n_pts, use_double = lod_points_per_thread(
            view, proj, bmin, bmax, W, H, POINTS_PER_THREAD, Debug.lod
        )
        b_pad = -(-las.num_batches // CHUNK) * CHUNK
        lod_full = np.zeros(b_pad, np.int32)
        lod_full[:B] = np.where(vis, n_pts, 0).astype(np.int32)
        Debug.clear_frame_stats()
        Debug.push_frame_stat("#batches loaded", str(B))
        Debug.push_frame_stat("#batches visible", str(int(vis.sum())))
        Debug.push_frame_stat(
            "#points budget", f"{int(lod_full.astype(np.int64).sum() * 1024):,}"
        )
        # the reference routes these batches through its f64 path
        # (render.cu:346-379); here EVERY batch projects batch-relative
        # with an f64-folded translation, so this is reporting-only
        Debug.push_frame_stat(
            "#batches close-up (f64-class precision)", str(int(use_double.sum()))
        )
        return wvp, lod_full

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
        fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
        B = las.num_batches_loaded
        if B == 0 or las.scale is None:
            return resolve(fb_p, W, H)

        wvp, lod_full = self.frame_setup(renderer)
        lod_dev = jnp.asarray(lod_full)

        if Debug.colorize_chunks:
            mode = "colorize_chunks"
        elif Debug.show_num_points:
            mode = "show_num_points"
        else:
            mode = "color"

        scale = jnp.asarray(las.scale, jnp.float32)
        offset_rel = jnp.asarray(las.offset - las.las_min, jnp.float32)
        t = jnp.asarray(wvp)

        from ..camera import batch_translations

        tb = jnp.asarray(batch_translations(
            (renderer.camera.proj() @ renderer.camera.view()),
            las.anchor_i[: las.dev["anchor"].shape[0]],
            las.scale, las.offset, las.las_min,
        ))
        nchunks = (B + CHUNK - 1) // CHUNK
        for c in range(nchunks):
            fb_d, fb_p = render_chunk(
                las.dev, c * CHUNK, t, lod_dev, scale, offset_rel,
                W, H, mode, fb_d, fb_p, tb,
            )

        renderer.last_fb = (fb_d, fb_p)
        img = None
        if mode == "colorize_chunks":
            img = jnp.where(
                fb_p != EMPTY, fb_p * jnp.uint32(1234567), jnp.uint32(0x00443322)
            ).reshape(H, W)
        elif mode == "show_num_points":
            shade = jnp.clip(
                (fb_p.astype(jnp.float32) / 64.0) * 255.0, 0, 255
            ).astype(jnp.uint32)
            gray = shade | (shade << 8) | (shade << 16)
            img = jnp.where(fb_p != EMPTY, gray, jnp.uint32(0x00443322)).reshape(H, W)
        else:
            img = resolve(fb_p, W, H)
        if Debug.show_bounding_box:
            from ..overlay import draw_bounding_boxes

            img = draw_bounding_boxes(
                img, jnp.asarray(las.bbox_min[:B]), jnp.asarray(las.bbox_max[:B]),
                jnp.asarray(wvp), W, H,
            )
        return img
