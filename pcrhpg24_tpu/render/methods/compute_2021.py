"""2021-paper baseline methods over the 16 B/point standard format.

The reference's five 2021 methods (modules/compute_2021_*: `early-z`,
`early-z & reduce`, `dedup`, `hqs`, `GL_POINTS`) differ only in *GPU
scheduling tricks* around the same math — early depth test before the
atomic, warp-level deduplication of identical pixels, ballot reductions
— plus one classic GL_POINTS vertex/fragment pipeline.  Here the
scatter-min framebuffer is already the "reduce" formulation, so `early-z`, `early-z & reduce`, `dedup` and
`GL_POINTS` are numerically one method here (registered under each
reference name for API parity, with identical images — which is also
true of the originals).  `hqs` is the average-blend variant.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import POINTS_PER_WORKGROUP, RENDER_CHUNK_BATCHES
from ...engine.method import Method, Runtime
from ..raster import (
    EMPTY, hqs_accumulate, merge_u64_min, resolve, resolve_hqs,
)
from .loop_las import resolve_indexed

CHUNK_PTS = RENDER_CHUNK_BATCHES * POINTS_PER_WORKGROUP


def _project_f32(fx, fy, fz, transform, base_index, width: int, height: int,
                 n_valid=None):
    """One chunk of f32 points -> (pid, depth, payload = point index);
    pid == width*height for a dropped point."""
    t = transform.astype(jnp.float32)
    cx = t[0, 0] * fx + t[0, 1] * fy + t[0, 2] * fz + t[0, 3]
    cy = t[1, 0] * fx + t[1, 1] * fy + t[1, 2] * fz + t[1, 3]
    w = t[3, 0] * fx + t[3, 1] * fy + t[3, 2] * fz + t[3, 3]
    ndc_x, ndc_y = cx / w, cy / w
    ok = (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    idx = base_index + jnp.arange(fx.shape[0])
    if n_valid is not None:
        ok &= idx < n_valid
    sx = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    sy = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    pid = jnp.where(ok, sx + sy * width, width * height)
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)
    return pid, depth, idx.astype(jnp.uint32)


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(5, 6))
def raster_chunk_f32(
    fx, fy, fz, transform, base_index, fb_d, fb_p, width: int, height: int,
    n_valid=None,
):
    return merge_u64_min(fb_d, fb_p, *_project_f32(
        fx, fy, fz, transform, base_index, width, height, n_valid))


class Compute2021(Method):
    VARIANTS = ("2021 early-z", "2021 early-z & reduce", "2021 dedup", "GL_POINTS")

    def __init__(self, renderer, las, name="2021 early-z"):
        self.name = name
        self.description = "2021 baseline; standard 16 byte per point"
        self.group = "2021 method; standard 16 byte per point"
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
        d = las.dev
        n_pad = d["fx"].shape[0]
        for s in range(0, n_pad, CHUNK_PTS):
            sl = slice(s, s + CHUNK_PTS)
            fb_d, fb_p = raster_chunk_f32(
                d["fx"][sl], d["fy"][sl], d["fz"][sl], wvp, jnp.uint32(s),
                fb_d, fb_p, W, H, jnp.uint32(las.num_points_loaded),
            )
        renderer.last_fb = (fb_d, fb_p)
        return resolve_indexed(fb_p, d["rgba"], W, H)


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(6, 7, 8, 9))
def hqs_chunk_f32(
    fx, fy, fz, rgba, transform, fb_depth, acc_r, acc_g, acc_b, acc_n,
    width: int, height: int, n_valid, base_index,
):
    pid, depth, _idx = _project_f32(fx, fy, fz, transform, base_index,
                                    width, height, n_valid)
    return hqs_accumulate((acc_r, acc_g, acc_b, acc_n), pid, depth, rgba,
                          fb_depth)


class Compute2021Hqs(Compute2021):
    def __init__(self, renderer, las):
        super().__init__(renderer, las, name="2021 hqs")
        self.description = "2021 HQS baseline (average blend)"

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        size = W * H
        if las.num_points_loaded == 0:
            return jnp.full((H, W), jnp.uint32(0x00443322))
        cam = renderer.camera
        wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
        d = las.dev
        n_pad = d["fx"].shape[0]
        fb_d = jnp.full((size,), EMPTY, jnp.uint32)
        fb_p = jnp.full((size,), EMPTY, jnp.uint32)
        for s in range(0, n_pad, CHUNK_PTS):
            sl = slice(s, s + CHUNK_PTS)
            fb_d, fb_p = raster_chunk_f32(
                d["fx"][sl], d["fy"][sl], d["fz"][sl], wvp, jnp.uint32(s),
                fb_d, fb_p, W, H, jnp.uint32(las.num_points_loaded),
            )
        acc = [jnp.zeros((size,), jnp.uint32) for _ in range(4)]
        for s in range(0, n_pad, CHUNK_PTS):
            sl = slice(s, s + CHUNK_PTS)
            acc = list(
                hqs_chunk_f32(
                    d["fx"][sl], d["fy"][sl], d["fz"][sl], d["rgba"][sl], wvp,
                    fb_d, *acc, W, H, jnp.uint32(las.num_points_loaded),
                    jnp.uint32(s),
                )
            )
        renderer.last_fb = (fb_d, acc[3])
        return resolve_hqs(*acc, W, H)
