"""Plain reference of the flagship frame, for checking it.

Straightforward and independent of the frame's own structure: points
decoded on the host by the NumPy mirror decoders, the same
batch-relative f32 projection as the flagship (render_chunk_native),
and one global resolve over linear pixel ids, with no chunking, no run
collapse, no swizzle and none of the frame's resolve code: for color a
lexicographic sort that puts each pixel's u64 (depth<<32|payload) min
first in its run, for HQS the 1% depth-tolerance gate and its sums
written out here.  The flagship must give the same image.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .camera import batch_translations
from .raster import BACKGROUND, EMPTY, resolve_hqs

POINTS = 64  # points per chain


def chain_payload_bc1(colors: np.ndarray) -> np.ndarray:
    """One batch's BC1 words (8192,) -> (65536,) u32 colors in chain
    layout (point i of chain c at c*64 + i; the reference's point ids)."""
    from ..codec.bc1 import decode_bc1

    return decode_bc1(np.asarray(colors, np.uint32), np.arange(65536))


@partial(jax.jit, static_argnames=("width", "height"))
def _project(coords, anchors, tb, lod_n, t, scale, width: int, height: int):
    """coords (B, 65536, 3) i32 chain layout -> (pid, depth) (B*65536,),
    pid == width*height for a dropped point."""
    rel = (coords - anchors[:, None, :]).astype(jnp.float32) * scale
    xs, ys, zs = rel[..., 0], rel[..., 1], rel[..., 2]
    cx = t[0, 0] * xs + t[0, 1] * ys + t[0, 2] * zs + tb[:, 0:1]
    cy = t[1, 0] * xs + t[1, 1] * ys + t[1, 2] * zs + tb[:, 1:2]
    w = t[3, 0] * xs + t[3, 1] * ys + t[3, 2] * zs + tb[:, 3:4]
    inv = 1.0 / w
    ndc_x, ndc_y = cx * inv, cy * inv
    i = jnp.arange(coords.shape[1]) % POINTS
    ok = (i[None, :] < lod_n[:, None]) & (w > 0)
    ok &= (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    px = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    py = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pid = jnp.where(ok, px + py * width, width * height)
    return pid.reshape(-1), jax.lax.bitcast_convert_type(w, jnp.uint32).reshape(-1)


@partial(jax.jit, static_argnames=("width", "height", "hqs"))
def _resolve(pid, depth, payload, width: int, height: int, hqs: bool):
    size = width * height
    # sorted by (pid, depth, payload), each pixel's winner heads its run;
    # dropped points (pid == size) sort last
    spid, sdep, spay = jax.lax.sort(
        [pid.astype(jnp.uint32), depth, payload], num_keys=3)
    head = jnp.concatenate([jnp.ones(1, bool), spid[1:] != spid[:-1]])
    tgt = jnp.where(head, spid, size).astype(jnp.int32)
    fb_d = jnp.full((size,), EMPTY, jnp.uint32).at[tgt].set(sdep, mode="drop")
    if not hqs:
        fb_p = jnp.full((size,), EMPTY, jnp.uint32).at[tgt].set(
            spay, mode="drop")
        img = jnp.where(fb_p != EMPTY, fb_p, BACKGROUND)
        return img.reshape(height, width), fb_d
    # a point counts if w <= 1.01 * its pixel's min w
    # (huffman_hqs/render.cu:296, sums render.cu:311-313)
    w = jax.lax.bitcast_convert_type(depth, jnp.float32)
    min_w = jax.lax.bitcast_convert_type(
        fb_d[jnp.minimum(pid, size - 1)], jnp.float32)
    tgt = jnp.where((pid < size) & (w <= min_w * 1.01), pid, size)
    sums = [jnp.zeros((size,), jnp.uint32).at[tgt].add(v, mode="drop")
            for v in (payload & 0xFF, (payload >> 8) & 0xFF,
                      (payload >> 16) & 0xFF, jnp.ones_like(payload))]
    return resolve_hqs(*sums, width, height), fb_d


def reference_image(coords, payload, anchors, lod_n, wvp, scale, offset,
                    las_min, width: int, height: int, hqs: bool = False,
                    device=None, depth: bool = False):
    """The frame's image from host-decoded points.

    coords (B, 65536, 3) i32 and payload (B, 65536) u32 in chain layout;
    anchors (B, 3) the per-batch i32 anchors (chain-start minimum);
    lod_n (B,) points per chain to draw (0 = culled); wvp the f64
    world-view-projection.  Runs on `device` (default: the first CPU).
    With `depth`, returns (image, min-depth plane (W*H,) u32 bits).
    """
    device = device or jax.devices("cpu")[0]
    tb = batch_translations(wvp, np.asarray(anchors, np.int64), scale,
                            offset, las_min)
    put = partial(jax.device_put, device=device)
    pid, depth_bits = _project(
        put(np.asarray(coords, np.int32)),
        put(np.asarray(anchors, np.int32)), put(tb),
        put(np.asarray(lod_n, np.int32)),
        put(np.asarray(wvp, np.float64).astype(np.float32)),
        put(np.asarray(scale, np.float32)), width, height)
    img, fb_d = _resolve(
        pid, depth_bits, put(np.asarray(payload, np.uint32).reshape(-1)),
        width, height, hqs)
    return (np.asarray(img), np.asarray(fb_d)) if depth else np.asarray(img)
