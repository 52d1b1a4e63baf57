"""Point rasterization with exact 64-bit depth-test semantics, in JAX.

The reference rasterizes with a u64 atomicMin per pixel over keys
`(f32_bits(clip.w) << 32) | payload` (reference: modules/
huffman_mem_iter_cuda/render.cu:276-303).  Without 64-bit scatters we
get the identical winner with two u32 scatter-min passes:

  1. scatter-min of depth bits per pixel,
  2. scatter-min of payload restricted to points whose depth equals the
     per-pixel minimum.

u64 min picks (min depth, then min payload among min-depth points) —
exactly what the two passes compute.  On the GPU each pass is an XLA
scatter with a min combiner, which lowers to atomics.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

EMPTY = jnp.uint32(0xFFFFFFFF)
BACKGROUND = jnp.uint32(0x00443322)  # resolve.cu:166

# Swizzled pixel-id space: the flagship resolve works in units of
# 32x32-px screen tiles instead of linear y*W+x ids, so a Morton-compact
# point cluster lands in few, square runs of framebuffer memory.
TILE_PX = 32  # tile edge


def swizzle_dims(width: int, height: int):
    """-> (tiles_x, tiles_y, swizzled id space size)."""
    wt = -(-width // TILE_PX)
    ht = -(-height // TILE_PX)
    return wt, ht, wt * ht * TILE_PX * TILE_PX


def swizzle_pid(px, py, width: int):
    """Pixel coords -> swizzled id ((ty*wt+tx)<<10 | ly<<5 | lx)."""
    wt = -(-width // TILE_PX)
    return (
        (((py >> 5) * wt + (px >> 5)) << 10) | ((py & 31) << 5) | (px & 31)
    )


def unswizzle_plane(fb, width: int, height: int):
    """Swizzled (wt*ht*1024,) plane -> linear (height*width,) plane."""
    wt, ht, _ = swizzle_dims(width, height)
    img = fb.reshape(ht, wt, TILE_PX, TILE_PX).transpose(0, 2, 1, 3)
    return img.reshape(ht * TILE_PX, wt * TILE_PX)[:height, :width].reshape(-1)


def swizzle_plane(fb, width: int, height: int, fill):
    """Linear (height*width,) plane -> swizzled (wt*ht*1024,) plane;
    pad pixels beyond the screen get `fill` (e.g. EMPTY for a depth
    plane: nothing ever lands there, and they never unswizzle back)."""
    wt, ht, _ = swizzle_dims(width, height)
    img = fb.reshape(height, width)
    img = jnp.pad(img, ((0, ht * TILE_PX - height), (0, wt * TILE_PX - width)),
                  constant_values=fill)
    return img.reshape(ht, TILE_PX, wt, TILE_PX).transpose(0, 2, 1, 3).reshape(-1)


def project(positions, transform):
    """positions (N,3) f32, transform (4,4) f32 -> clip (N,4).

    Written as explicit multiply-adds: a matmul here may run at reduced
    precision (TF32 on the GPU) and destroy the depth bits.
    """
    t = transform.astype(jnp.float32)
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    cols = [t[i, 0] * x + t[i, 1] * y + t[i, 2] * z + t[i, 3] for i in range(4)]
    return jnp.stack(cols, axis=-1)


def scatter_u64_min(pid, depth, payload, size: int):
    """Exact u64 (depth<<32|payload) scatter-min into a cleared framebuffer.

    pid: (N,) i32 pixel ids with out-of-range == dropped; depth/payload
    u32.  Returns (fb_depth, fb_payload) each (size,) u32, EMPTY where no
    point landed (the reference clears the fb to 0xFF bytes,
    huffman_mem_iter_cuda.h:250).
    """
    empty = jnp.full((size,), EMPTY, jnp.uint32)
    return merge_u64_min(empty, empty, pid, depth, payload)


@partial(jax.jit, static_argnames=("width", "height"))
def rasterize(positions, payload, transform, width: int, height: int, mask=None):
    """Scatter points into (H*W,) u32 depth + payload framebuffers.

    positions: (N,3) f32 in render frame; payload: (N,) u32; transform:
    (4,4) worldViewProj.  Returns (fb_depth, fb_payload) flattened row-
    major, y-up (GL convention; flip when exporting images).
    """
    clip = project(positions, transform)
    w = clip[:, 3]
    ndc_x = clip[:, 0] / w
    ndc_y = clip[:, 1] / w
    # accept test, render.cu:296
    ok = (w > 0) & (ndc_x >= -1) & (ndc_x <= 1) & (ndc_y >= -1) & (ndc_y <= 1)
    if mask is not None:
        ok &= mask
    px = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    py = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pid = jnp.where(ok, px + py * width, width * height)
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)
    return scatter_u64_min(pid, depth, payload, width * height)


def merge_u64_min(fb_d, fb_p, pid, depth, payload):
    """Min-merge points into a running framebuffer, exact u64 semantics.

    Returns the planes of min((fb_d<<32|fb_p), (depth<<32|payload)) per
    pixel.  A pixel whose depth improves drops its old payload; one whose
    depth ties keeps it as a candidate.  u64-min is associative over any
    partition of the points, so merging chunk by chunk equals one global
    resolve.  pid: (N,) ids, out-of-range == dropped.
    """
    size = fb_d.shape[0]
    new_d = fb_d.at[pid].min(depth, mode="drop")
    ok = (pid >= 0) & (pid < size)
    winner = ok & (depth == new_d[jnp.clip(pid, 0, size - 1)])
    keep_p = jnp.where(new_d == fb_d, fb_p, EMPTY)
    new_p = keep_p.at[jnp.where(winner, pid, size)].min(payload, mode="drop")
    return new_d, new_p


def hqs_accumulate(acc, pid, depth, rgba, fb_depth):
    """Add one chunk's depth-tolerance-gated colours to the HQS sums.

    acc: (r, g, b, n) u32 planes; fb_depth: the frame's min-depth plane
    (u32 bits of clip.w).  A point counts if w <= 1.01 * the pixel's
    min w (reference: huffman_hqs/render.cu:311-313).  Sums are exact
    and associative over any partition of the points.
    """
    size = fb_depth.shape[0]
    w = jax.lax.bitcast_convert_type(depth, jnp.float32)
    old = jax.lax.bitcast_convert_type(
        fb_depth[jnp.clip(pid, 0, size - 1)], jnp.float32)
    keep = (pid >= 0) & (pid < size) & (w <= old * 1.01)
    pid2 = jnp.where(keep, pid, size)
    acc_r, acc_g, acc_b, acc_n = acc
    return (acc_r.at[pid2].add(rgba & 0xFF, mode="drop"),
            acc_g.at[pid2].add((rgba >> 8) & 0xFF, mode="drop"),
            acc_b.at[pid2].add((rgba >> 16) & 0xFF, mode="drop"),
            acc_n.at[pid2].add(jnp.uint32(1), mode="drop"))


@partial(jax.jit, static_argnames=("width", "height"))
def resolve(fb_payload, width: int, height: int):
    """Framebuffer -> (H, W) u32 RGBA image (resolve.cu:149-191)."""
    color = jnp.where(fb_payload != EMPTY, fb_payload, BACKGROUND)
    return color.reshape(height, width)


@partial(jax.jit, static_argnames=("width", "height"))
def resolve_hqs(acc_r, acc_g, acc_b, acc_n, width: int, height: int):
    """HQS sums -> (H, W) image of the averaged colors (resolve.cu:29-41).

    Any (height*width,) slice of linear planes works: the sharded frames
    resolve their own rows."""
    cnt = jnp.maximum(acc_n, 1)
    color = (acc_r // cnt) | ((acc_g // cnt) << 8) | ((acc_b // cnt) << 16)
    return jnp.where(acc_n > 0, color, BACKGROUND).reshape(height, width)


@partial(jax.jit, static_argnames=("width", "height"))
def edl_shade(img, fb_d, width: int, height: int, strength=0.0005):
    """Eye-dome lighting: darken pixels occluded by nearer neighbors.

    Mirrors the reference resolve's EDL block
    (modules/compute_loop_las/resolve.cs:143-188): per pixel, sum
    max(0, depth - neighbourDepth) over the 3x3 neighborhood, response
    = sum/9, shade = exp(-response * 300 * strength), RGB *= shade.
    Empty neighbors contribute no occlusion (depth +inf); empty pixels
    keep the background color.  `img` (H, W) u32, `fb_d` (W*H,) u32
    depth bits in LINEAR pixel space.
    """
    bits = fb_d.reshape(height, width)
    d = jax.lax.bitcast_convert_type(bits, jnp.float32)
    empty = bits == EMPTY
    d = jnp.where(empty, jnp.inf, d)
    pad = jnp.pad(d, 1, constant_values=jnp.inf)
    s = jnp.zeros_like(d)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            nb = pad[1 + oy : 1 + oy + height, 1 + ox : 1 + ox + width]
            s = s + jnp.maximum(0.0, d - nb)
    shade = jnp.exp(-(s / 9.0) * 300.0 * jnp.float32(strength))
    ch = lambda sh: jnp.minimum(
        ((img >> sh) & 0xFF).astype(jnp.float32) * shade, 255.0
    ).astype(jnp.uint32)
    shaded = ch(0) | (ch(8) << 8) | (ch(16) << 16)
    return jnp.where(empty, img, shaded)


def image_to_rgb8(image_u32):
    """(H,W) u32 (R | G<<8 | B<<16) -> (H,W,3) u8, flipped to y-down."""
    img = image_u32[::-1]
    r = (img & 0xFF).astype(jnp.uint8)
    g = ((img >> 8) & 0xFF).astype(jnp.uint8)
    b = ((img >> 16) & 0xFF).astype(jnp.uint8)
    return jnp.stack([r, g, b], axis=-1)
