"""`huffman_tpu` — flagship fused decode + rasterize on the native format.

Same per-frame behavior as `huffman_mem_iter` (frustum cull, LOD,
decode every visible batch, exact depth-test raster — reference:
modules/huffman_mem_iter_cuda/), on the `.tpc` device layout: fbatch
(v2, the flagship) or tbatch (v1) geometry decodes chunk by chunk, each
chunk projects batch-relative, collapses same-pixel runs within chains,
and min-merges into the frame's framebuffer with exact u64
(depth<<32|payload) semantics (raster.merge_u64_min).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import POINTS_PER_THREAD
from ...engine.debug import Debug
from ..camera import frame_setup_device
from ..native_decode_xla import decode_fixed, decode_native_xla
from ..raster import (
    EMPTY, merge_u64_min, resolve, swizzle_dims, swizzle_pid,
    unswizzle_plane,
)
from .huffman_mem_iter import HuffmanMemIter, _slice_rows

# batches decoded per loop step (64 batches = 4.2M points)
CHUNK = 64


def render_chunk_native(
    dev, chunk_start, transform, lod_n, scale, offset_rel,
    width: int, height: int, mode: str,
    points: int = POINTS_PER_THREAD, fmt: str = "tbatch", tb=None,
    nbatches: int = CHUNK, color_fmt: str = "bc1",
):
    """Decode + project one chunk; returns flat (pid, depth, payload).

    pids are in the swizzled tile id space (raster.swizzle_pid), with
    `size` marking a dropped point.
    fmt: "fixed" (v2 fbatch, flagship) or "tbatch" (v1 bucket-Huffman).
    tb: optional (B, 4) f32 per-batch folded translation columns
    (camera.batch_translations) — when given, coordinates are projected
    batch-RELATIVE to dev["anchor"], the equivalent of the reference's
    double-precision close-up path (render.cu:459-461).
    """
    C = nbatches
    if fmt == "fixed":
        coords = decode_fixed(
            _slice_rows(dev["widths"], chunk_start, C),
            _slice_rows(dev["streams"], chunk_start, C),
            _slice_rows(dev["ptrs"], chunk_start, C),
            _slice_rows(dev["starts"], chunk_start, C),
            points=points,
        )
    else:
        coords = decode_native_xla(
            _slice_rows(dev["lj"], chunk_start, C),
            _slice_rows(dev["streams"], chunk_start, C),
            _slice_rows(dev["ptrs"], chunk_start, C),
            _slice_rows(dev["dD"], chunk_start, C),
            _slice_rows(dev["lut"], chunk_start, C),
            _slice_rows(dev["starts"], chunk_start, C),
            points=points,
        )  # (C, points, 3, 8, 128) i32
    colors = _slice_rows(dev["colors"], chunk_start, C)
    n_chunk = _slice_rows(lod_n, chunk_start, C)

    # positions componentwise in the decoder's layout (C, points, 8, 128)
    t = transform.astype(jnp.float32)
    if tb is not None:
        # batch-relative precision path: small i32 offsets from the
        # per-batch anchor stay exact in f32; the anchor's world-space
        # contribution arrives pre-folded (f64 on host) in tb
        anchor = _slice_rows(dev["anchor"], chunk_start, C)  # (C, 3) i32
        tbc = _slice_rows(tb, chunk_start, C)  # (C, 4) f32
        bc = lambda a: a[:, None, None, None]
        xs = (coords[:, :, 0] - bc(anchor[:, 0])).astype(jnp.float32) * scale[0]
        ys = (coords[:, :, 1] - bc(anchor[:, 1])).astype(jnp.float32) * scale[1]
        zs = (coords[:, :, 2] - bc(anchor[:, 2])).astype(jnp.float32) * scale[2]
        cx = t[0, 0] * xs + t[0, 1] * ys + t[0, 2] * zs + bc(tbc[:, 0])
        cy = t[1, 0] * xs + t[1, 1] * ys + t[1, 2] * zs + bc(tbc[:, 1])
        w = t[3, 0] * xs + t[3, 1] * ys + t[3, 2] * zs + bc(tbc[:, 3])
    else:
        xs = coords[:, :, 0].astype(jnp.float32) * scale[0] + offset_rel[0]
        ys = coords[:, :, 1].astype(jnp.float32) * scale[1] + offset_rel[1]
        zs = coords[:, :, 2].astype(jnp.float32) * scale[2] + offset_rel[2]
        cx = t[0, 0] * xs + t[0, 1] * ys + t[0, 2] * zs + t[0, 3]
        cy = t[1, 0] * xs + t[1, 1] * ys + t[1, 2] * zs + t[1, 3]
        w = t[3, 0] * xs + t[3, 1] * ys + t[3, 2] * zs + t[3, 3]

    inv = 1.0 / w
    ndc_x = cx * inv
    ndc_y = cy * inv
    shp = xs.shape  # (C, points, 8, 128)
    pt_idx = jnp.arange(points, dtype=jnp.int32)
    mask = jnp.broadcast_to(
        pt_idx[None, :, None, None] < n_chunk[:, None, None, None], shp
    )
    ok = mask & (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    px = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    py = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    # swizzled 32x32-px tile id space (raster.swizzle_pid)
    _wt, _ht, size = swizzle_dims(width, height)
    pid = jnp.where(ok, swizzle_pid(px, py, width), size)
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)

    if mode == "colorize_chunks":
        payload = jnp.broadcast_to(
            (chunk_start + jnp.arange(C)).astype(jnp.uint32)[:, None, None, None], shp
        )
    elif mode == "show_num_points":
        payload = jnp.broadcast_to(
            n_chunk.astype(jnp.uint32)[:, None, None, None], shp
        )
    else:
        from ..bc1_layout import PAYLOAD_NATIVE

        # color decode by format (reference COLOR_COMPRESSION 0|1|7,
        # GPU decoders render.cu:67-154)
        payload = PAYLOAD_NATIVE[color_fmt](colors, shp, points).astype(
            jnp.uint32)

    # Within-chain run collapse: Morton order makes consecutive points of
    # a chain (axis 1) land on the same pixel, especially zoomed out.
    # Collapse each such run to its exact u64 (depth<<32|payload) min and
    # retire the rest to the OOB sentinel, so fewer points reach the
    # resolve.  Bit-exact: only same-pixel candidates collapse, and their
    # min is kept.  (The reference has no analogue — its atomicMin
    # absorbs duplicates in silicon, render.cu:276-303.)
    if mode == "color":
        d, p = depth, payload
        for s in (1, 2, 4, 8, 16, 32):
            if s >= points:
                break
            pad = [(0, 0), (0, s), (0, 0), (0, 0)]
            pid_s = jnp.pad(pid, pad, constant_values=size)[:, s:]
            d_s = jnp.pad(d, pad)[:, s:]
            p_s = jnp.pad(p, pad)[:, s:]
            valid = pid_s == pid
            less = (d_s < d) | ((d_s == d) & (p_s < p))
            take = valid & less
            d = jnp.where(take, d_s, d)
            p = jnp.where(take, p_s, p)
        prev = jnp.pad(pid, [(0, 0), (1, 0), (0, 0), (0, 0)],
                       constant_values=size)[:, :points]
        head = pid != prev
        pid = jnp.where(head, pid, size)
        depth, payload = d, p

    return pid.reshape(-1), depth.reshape(-1), payload.reshape(-1)


def frame_lod(dev, frame_params, width: int, height: int, cull: bool,
              points: int, n_loaded=None):
    """Device cull + LOD of every batch -> (lod_n (B,) i32, transform).

    frame_params: (40,) f32 — view(16) | proj_params(6) | lod_floor | B |
    wvp(16, host-computed in f64 then cast: keeps depth bits identical to
    the host-transform methods).  `n_loaded` overrides the loaded batch
    count (a shard's own count under a mesh).
    """
    if n_loaded is None:
        n_loaded = frame_params[23].astype(jnp.int32)
    lod_n = frame_setup_device(
        frame_params[0:16].reshape(4, 4), frame_params[16:22],
        dev["bbox_min"], dev["bbox_max"], n_loaded, width, height,
        frame_params[22], cull,
    )
    # the decode bucket `points` comes from the host f64 LOD; the device
    # f32 LOD could exceed it by one ulp at a bucket boundary, which would
    # silently mask-in points that were never decoded — clamp so the
    # static bucket is authoritative either way
    return jnp.minimum(lod_n, points), frame_params[24:40].reshape(4, 4)


def live_chunk_loop(lod_n, nchunks: int, chunk: int, body, init):
    """carry = body(c, carry) for every chunk c holding a visible batch.

    A chunk with no visible batch skips its whole decode + project +
    resolve (close-up views cull most of a large scene, and Morton order
    keeps the visible batches in few contiguous chunks — the reference
    analogue is not launching blocks for culled batches).  One
    `while_loop` with a dynamic trip count: the program stays O(1) in
    scene size.
    """
    live = (lod_n[: nchunks * chunk].reshape(nchunks, chunk) > 0).any(axis=1)
    order = jnp.argsort(~live, stable=True).astype(jnp.int32)
    n_live = live.sum().astype(jnp.int32)

    def step(st):
        g, carry = st
        return g + 1, body(order[g], carry)

    return jax.lax.while_loop(lambda st: st[0] < n_live, step,
                              (jnp.int32(0), init))[1]


@partial(
    jax.jit,
    static_argnames=("width", "height", "mode", "nchunks", "cull", "points",
                     "fmt", "color_fmt"),
)
def render_frame_native(
    dev, frame_params, scale, offset_rel,
    width: int, height: int, mode: str, nchunks: int,
    cull: bool, points: int = POINTS_PER_THREAD,
    fmt: str = "tbatch", tb=None, color_fmt: str = "bc1",
):
    """Whole frame in one dispatch: cull/LOD + per-chunk decode, project
    and min-merge into one framebuffer.

    frame_params: see frame_lod — the frame's only host->device
    transfer besides `tb`.  Returns (fb_d, fb_p, img) with the planes in
    linear pixel space.
    """
    lod_n, transform = frame_lod(dev, frame_params, width, height, cull,
                                 points)
    _wt, _ht, size = swizzle_dims(width, height)

    def chunk_points(c):
        pid, dep, pay = render_chunk_native(
            dev, c * CHUNK, transform, lod_n, scale, offset_rel,
            width, height, mode, points, fmt, tb, color_fmt=color_fmt,
        )
        return pid.astype(jnp.int32), dep, pay

    if mode == "colorize_overdraw":
        # per-pixel point counts -> 5-bucket spectral heatmap (debug mode;
        # reference: compute_loop_las_hqs/resolve.cs:54-103)
        def count(c, counts):
            pid, _dep, _pay = chunk_points(c)
            return counts.at[pid].add(jnp.uint32(1), mode="drop")

        counts = live_chunk_loop(lod_n, nchunks, CHUNK, count,
                                 jnp.zeros((size,), jnp.uint32))
        counts = unswizzle_plane(counts, width, height)
        color = jnp.full((width * height,), 0x00BA832B, jnp.uint32)
        for thresh, c in ((10, 0x00A4DDAB), (250, 0x00BFFFFF),
                          (1000, 0x0061AEFD), (4000, 0x001C19D7)):
            color = jnp.where(counts >= thresh, jnp.uint32(c), color)
        img = jnp.where(
            counts > 0, color, jnp.uint32(0x00443322)
        ).reshape(height, width)
        return None, counts, img

    def merge(c, fb):
        return merge_u64_min(*fb, *chunk_points(c))

    empty = jnp.full((size,), EMPTY, jnp.uint32)
    fb_d, fb_p = live_chunk_loop(lod_n, nchunks, CHUNK, merge,
                                 (empty, empty))
    # back to linear pixel ids for all external consumers
    fb_p = unswizzle_plane(fb_p, width, height)
    fb_d = unswizzle_plane(fb_d, width, height)
    if mode == "colorize_chunks":
        img = jnp.where(
            fb_p != EMPTY, fb_p * jnp.uint32(1234567), jnp.uint32(0x00443322)
        ).reshape(height, width)
    elif mode == "show_num_points":
        shade = jnp.clip(
            (fb_p.astype(jnp.float32) / 64.0) * 255.0, 0, 255
        ).astype(jnp.uint32)
        gray = shade | (shade << 8) | (shade << 16)
        img = jnp.where(fb_p != EMPTY, gray, jnp.uint32(0x00443322)).reshape(
            height, width
        )
    else:
        img = jnp.where(fb_p != EMPTY, fb_p, jnp.uint32(0x00443322)).reshape(
            height, width
        )
    return fb_d, fb_p, img


class HuffmanTpu(HuffmanMemIter):
    """Flagship native-format method (`.tpc` decode + rasterize)."""

    def __init__(self, renderer, tpc):
        self.name = "huffman_tpu"
        self.description = "fused native-format decode + rasterize"
        self.group = "huffman"
        self.las = tpc
        self.renderer = renderer

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
        fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
        B = las.num_batches_loaded
        if B == 0:
            return resolve(fb_p, W, H)

        mode = (
            "colorize_chunks"
            if Debug.colorize_chunks
            else "show_num_points" if Debug.show_num_points
            else "colorize_overdraw" if Debug.colorize_overdraw
            else "color"
        )
        if not hasattr(las, "_dev_consts"):
            las._dev_consts = (
                jnp.asarray(las.scale, jnp.float32),
                jnp.asarray(las.offset - las.las_min, jnp.float32),
            )
        scale, offset_rel = las._dev_consts

        cam = renderer.camera
        fp = np.zeros(40, np.float32)
        fp[0:16] = cam.view().astype(np.float32).reshape(-1)
        fp[16:22] = cam.proj_params().astype(np.float32)
        fp[22] = Debug.lod
        fp[23] = float(B)
        fp[24:40] = (cam.proj() @ cam.view()).astype(np.float32).reshape(-1)
        # LOD bucket: decode only ceil(max_lod/16)*16 points per chain
        # (static-shape variant of render.cu:428's early loop exit);
        # shrinks decode AND resolve volume when zoomed out
        _, lod_full = self.frame_setup(renderer)
        max_lod = int(lod_full.max()) if B else POINTS_PER_THREAD
        points = max(16, -(-max_lod // 16) * 16)
        fmt = "fixed" if getattr(las, "version", 1) == 2 else "tbatch"
        # per-batch folded translations: the reference's f64 close-up
        # precision (render.cu:459-461), O(batches) host f64 per frame
        from ..camera import batch_translations

        tb = batch_translations(
            (cam.proj() @ cam.view()), las.anchor_i[: las.dev["anchor"].shape[0]],
            las.scale, las.offset, las.las_min,
        )
        # ONE host->device transfer per frame: frame params and the
        # per-batch folded translations ride a single packed array and
        # split on device (the reference's analogue is one
        # ChangingRenderData upload, huffman_mem_iter_cuda.h:160-183)
        packed = jnp.asarray(np.concatenate(
            [fp, np.asarray(tb, np.float32).ravel()]))
        # nchunks is the SCENE capacity, not the loaded count: chunks
        # beyond num_batches_loaded skip via the live-chunk cond (their
        # lod_n is 0), so streaming loads render without recompiling
        # the frame for every upload step
        fb_d, fb_p, img = render_frame_native(
            las.dev, packed[:40], scale, offset_rel, W, H, mode,
            (las.num_batches + CHUNK - 1) // CHUNK,
            Debug.frustum_culling_enabled and Debug.update_frustum,
            points, fmt, packed[40:].reshape(-1, 4),
            color_fmt=getattr(las, "color_fmt", "bc1"),
        )
        renderer.last_fb = (fb_d, fb_p)
        if Debug.show_bounding_box:
            from ..overlay import draw_bounding_boxes

            img = draw_bounding_boxes(
                img, las.dev["bbox_min"][:], las.dev["bbox_max"][:],
                jnp.asarray(fp[24:40].reshape(4, 4)), W, H,
            )
        return img
