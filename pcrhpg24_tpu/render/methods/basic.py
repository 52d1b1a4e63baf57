"""`basic` — simplest dense method: raw int32 SoA, scale+offset, raster.

Replicates modules/basic_cuda (render.cu:96-140): position = int coords
* scale + (offset - las_min), payload = point index, color at resolve.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import POINTS_PER_WORKGROUP, RENDER_CHUNK_BATCHES
from ...engine.method import Method, Runtime
from ..raster import EMPTY, merge_u64_min, resolve
from .loop_las import resolve_indexed

CHUNK_PTS = RENDER_CHUNK_BATCHES * POINTS_PER_WORKGROUP


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(7, 8))
def raster_chunk_basic(
    x, y, z, scale, offset_rel, transform, base_index, fb_d, fb_p,
    width: int, height: int, n_valid=None,
):
    px_ = x.astype(jnp.float32) * scale[0] + offset_rel[0]
    py_ = y.astype(jnp.float32) * scale[1] + offset_rel[1]
    pz_ = z.astype(jnp.float32) * scale[2] + offset_rel[2]
    t = transform.astype(jnp.float32)
    cx = t[0, 0] * px_ + t[0, 1] * py_ + t[0, 2] * pz_ + t[0, 3]
    cy = t[1, 0] * px_ + t[1, 1] * py_ + t[1, 2] * pz_ + t[1, 3]
    w = t[3, 0] * px_ + t[3, 1] * py_ + t[3, 2] * pz_ + t[3, 3]
    ndc_x, ndc_y = cx / w, cy / w
    ok = (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    if n_valid is not None:
        ok &= (base_index + jnp.arange(x.shape[0])) < n_valid
    sx = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    sy = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    size = width * height
    pid = jnp.where(ok, sx + sy * width, size)
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)
    payload = (base_index + jnp.arange(x.shape[0])).astype(jnp.uint32)
    return merge_u64_min(fb_d, fb_p, pid, depth, payload)


class BasicMethod(Method):
    def __init__(self, renderer, las, name="basic"):
        self.name = name
        self.description = "raw int32 SoA, scale+offset, rasterize"
        self.group = "none"
        self.las = las
        self.renderer = renderer

    def update(self, renderer):
        if Runtime.resource is not self.las:
            if Runtime.resource is not None:
                Runtime.resource.unload(renderer)
            self.las.load(renderer)
            Runtime.resource = self.las

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
        fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
        if las.num_points_loaded == 0:
            return resolve(fb_p, W, H)
        cam = renderer.camera
        wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
        scale = jnp.asarray(las.scale, jnp.float32)
        offset_rel = jnp.asarray(las.offset - las.las_min, jnp.float32)
        d = las.dev
        n_pad = d["x"].shape[0]
        for s in range(0, n_pad, CHUNK_PTS):
            sl = slice(s, s + CHUNK_PTS)
            fb_d, fb_p = raster_chunk_basic(
                d["x"][sl], d["y"][sl], d["z"][sl], scale, offset_rel, wvp,
                jnp.uint32(s), fb_d, fb_p, W, H,
                jnp.uint32(las.num_points_loaded),
            )
        renderer.last_fb = (fb_d, fb_p)
        return resolve_indexed(fb_p, d["rgba"], W, H)
