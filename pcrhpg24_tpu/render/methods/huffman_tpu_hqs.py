"""`huffman_tpu_hqs` — HQS over the native format.

Same three-pass semantics as `huffman_hqs` (reference: modules/
huffman_hqs/: depth prepass + 1%-depth-tolerance average blend + divide
resolve, huffman_hqs.h:198-259) on the flagship pipeline.  Like the
reference (depth.cu, then render.cu), the frame decodes every visible
chunk twice: once for the min-depth plane, once for the tolerance-gated
(r, g, b, count) sums.  Both passes are live-chunk loops inside ONE jit
program, so its size does not grow with the scene.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...engine.debug import Debug
from ..raster import (
    EMPTY, hqs_accumulate, resolve_hqs, swizzle_dims, unswizzle_plane,
)
from .huffman_tpu import (
    CHUNK, HuffmanTpu, frame_lod, live_chunk_loop, render_chunk_native,
)


@partial(
    jax.jit,
    static_argnames=("width", "height", "nchunks", "cull", "fmt", "points",
                     "color_fmt"),
)
def hqs_frame_native(dev, frame_params, scale, offset_rel,
                     width: int, height: int, nchunks: int, cull: bool,
                     fmt: str = "tbatch", tb=None, points: int = 64,
                     color_fmt: str = "bc1"):
    """Full HQS frame: min-depth pass + tolerance blend + divide.

    Returns (fb_depth, acc_n, img), planes in linear pixel space.
    """
    lod_n, transform = frame_lod(dev, frame_params, width, height, cull,
                                 points)
    _wt, _ht, size = swizzle_dims(width, height)

    def chunk_points(c):
        pid, dep, rgba = render_chunk_native(
            dev, c * CHUNK, transform, lod_n, scale, offset_rel,
            width, height, "hqs", points, fmt, tb, color_fmt=color_fmt,
        )
        return pid.astype(jnp.int32), dep, rgba

    def depth_pass(c, fbd):
        pid, dep, _rgba = chunk_points(c)
        return fbd.at[pid].min(dep, mode="drop")

    fb_depth = live_chunk_loop(lod_n, nchunks, CHUNK, depth_pass,
                               jnp.full((size,), EMPTY, jnp.uint32))

    def blend_pass(c, acc):
        return hqs_accumulate(acc, *chunk_points(c), fb_depth)

    zeros = jnp.zeros((size,), jnp.uint32)
    acc = live_chunk_loop(lod_n, nchunks, CHUNK, blend_pass, (zeros,) * 4)
    acc = [unswizzle_plane(a, width, height) for a in acc]
    img = resolve_hqs(*acc, width, height)
    return unswizzle_plane(fb_depth, width, height), acc[3], img


class HuffmanTpuHqs(HuffmanTpu):
    def __init__(self, renderer, tpc):
        super().__init__(renderer, tpc)
        self.name = "huffman_tpu_hqs"
        self.description = "HQS average blend, native-format decode"

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        B = las.num_batches_loaded
        if B == 0:
            return jnp.full((H, W), jnp.uint32(0x00443322))
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
        _, lod_full = self.frame_setup(renderer)
        max_lod = int(lod_full.max()) if B else 64
        points = max(16, -(-max_lod // 16) * 16)
        from ..camera import batch_translations

        tb = jnp.asarray(batch_translations(
            (cam.proj() @ cam.view()),
            las.anchor_i[: las.dev["anchor"].shape[0]],
            las.scale, las.offset, las.las_min,
        ))
        fb_depth, acc_n, img = hqs_frame_native(
            las.dev, jnp.asarray(fp), scale, offset_rel, W, H,
            (las.num_batches + CHUNK - 1) // CHUNK,
            Debug.frustum_culling_enabled and Debug.update_frustum,
            "fixed" if getattr(las, "version", 1) == 2 else "tbatch", tb,
            points, getattr(las, "color_fmt", "bc1"),
        )
        renderer.last_fb = (fb_depth, acc_n)
        return img
