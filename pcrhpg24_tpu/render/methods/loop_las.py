"""`loop_las` family — adaptive 10/20/30-bit fixed-point methods.

Replicates modules/compute_loop_las (+las2) and compute_loop_las_hqs:
per batch, a precision level is chosen from the projected bbox size
(render.cs:235-271: <100px -> 10 bit, <500 -> 20 bit via levels, else
30 bit), coordinates unpack from up to three 10-10-10 u32 planes
batch-relative, and points rasterize with the point *index* as payload
(render.cs:527-533); the resolve looks colors up by index.

Note: the reference's 30-bit unpack has a copy-paste defect (render.cs:
456-458 ORs X_12 into Y and Z).  We implement the evident intent, not
the defect.

`loop_las2`'s uvec4 double-buffered prefetch (compute_loop_las2/
render.cs:300-446) is a hand-coalescing technique that XLA's dense plane
streaming already covers, so it is registered as an alias with
identical numerics.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...constants import POINTS_PER_WORKGROUP, RENDER_CHUNK_BATCHES
from ...engine.debug import Debug
from ...engine.method import Method, Runtime
from ..camera import batches_in_frustum, frustum_planes
from ..raster import (
    EMPTY, hqs_accumulate, merge_u64_min, resolve, resolve_hqs,
)

CHUNK_PTS = RENDER_CHUNK_BATCHES * POINTS_PER_WORKGROUP
STEPS_30BIT = float(1 << 30)
STEPS_10BIT = 1024.0
MASK = 1023


def precision_levels(view, proj, bbox_min, bbox_max, width, height):
    """Per-batch level 0..4 (render.cs:235-271)."""
    center = 0.5 * (bbox_min + bbox_max)
    radius = np.linalg.norm(bbox_min - bbox_max, axis=1)
    ch = np.concatenate([center, np.ones((len(center), 1))], 1)
    vc = ch @ view.T
    ve = vc + np.stack([radius, *([np.zeros_like(radius)] * 3)], 1)
    pc = vc @ proj.T
    pe = ve @ proj.T
    sc = 0.5 * (pc[:, :2] / pc[:, 3:4] + 1) * [width, height]
    se = 0.5 * (pe[:, :2] / pe[:, 3:4] + 1) * [width, height]
    ps = np.linalg.norm(se - sc, axis=1)
    level = np.full(len(ps), 0, np.int32)
    level[ps < 10000] = 1
    level[ps < 500] = 2
    level[ps < 200] = 3
    level[ps < 100] = 4
    return level


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(8, 9))
def raster_chunk_101010(
    xyz4, xyz8, xyz12, level_pt, bmin_pt, bmax_pt, transform, base_index,
    fb_d, fb_p, width: int, height: int, mask_pt=None,
):
    """One chunk of packed points -> framebuffer (render.cs:390-545)."""
    pid, depth, payload = _project_101010(
        xyz4, xyz8, xyz12, level_pt, bmin_pt, bmax_pt, transform,
        base_index, width, height, mask_pt,
    )
    return merge_u64_min(fb_d, fb_p, pid, depth, payload)



def project_101010_planes(
    xyz4, xyz8, xyz12, code_pt, bmi, bma, transform,
    base_index, width: int, height: int, payload=None,
):
    """Plane-input projection for the Potree frames: per-point node
    attributes arrive as materialized planes (code_pt i32 plane; bmi/bma
    3-tuples of f32 planes).  Returns (pid, depth, payload) with pids in
    the SWIZZLED tile id space (raster.swizzle_pid), `size` = dropped."""
    from ..raster import swizzle_dims, swizzle_pid

    lvl = (code_pt >> 1) & 7
    vis = (code_pt & 1) == 1
    pid, depth, pay_idx = _project_101010(
        xyz4, xyz8, xyz12, lvl, bmi, bma, transform, base_index,
        width, height, vis,
    )
    # default payload = global point index (resolve_indexed colors);
    # HQS passes the rgba plane directly (sums want color bytes)
    payload = pay_idx if payload is None else payload.astype(jnp.uint32)
    _wt, _ht, size = swizzle_dims(width, height)
    lin = jnp.clip(pid, 0, width * height - 1)
    spid = jnp.where(pid < width * height,
                     swizzle_pid(lin % width, lin // width, width), size)
    return spid, depth, payload


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(9, 10))
def raster_chunk_101010_nodes(
    xyz4, xyz8, xyz12, nid, bmin_nodes, bmax_nodes, code_nodes, transform,
    base_index, fb_d, fb_p, width: int, height: int, starts_nodes=None,
):
    """Node-indexed variant for billion-point Potree scenes.

    Per-point bbox/level/visibility come from O(nodes) device tables
    gathered by the per-point node id `nid` (u32) instead of per-point
    f32 planes — 4 B/point of residency instead of 28 B/point, the
    difference between a 350M-point resident set fitting HBM or not.
    `code_nodes` packs (take << 4 | level << 1 | visible) per node;
    same numerics as raster_chunk_101010 (the gathered values are
    identical).  `starts_nodes` enables the per-node prefix point
    budget: only the node's first `take` points render (node_budget;
    reference analogue render.cu:346-379).
    Reference analogue: per-node uniforms read by each workgroup
    (modules/compute_loop_nodes/compute_loop_nodes.h:184-185).
    """
    nidc = jnp.clip(nid, 0, code_nodes.shape[0] - 1).astype(jnp.int32)
    code = code_nodes[nidc]
    lvl = (code >> 1) & 7
    vis = (code & 1) == 1
    if starts_nodes is not None:
        local = (base_index.astype(jnp.int32)
                 + jnp.arange(xyz4.shape[0], dtype=jnp.int32)
                 - starts_nodes[nidc])
        vis &= local < (code >> 4)  # prefix budget (node_budget)
    # per-axis 1D gathers of the node tables
    bmi = tuple(bmin_nodes[:, k][nidc] for k in range(3))
    bma = tuple(bmax_nodes[:, k][nidc] for k in range(3))
    pid, depth, payload = _project_101010(
        xyz4, xyz8, xyz12, lvl, bmi, bma, transform, base_index,
        width, height, vis,
    )
    return merge_u64_min(fb_d, fb_p, pid, depth, payload)


def _project_101010(
    xyz4, xyz8, xyz12, level_pt, bmin_pt, bmax_pt, transform, base_index,
    width: int, height: int, mask_pt=None,
):
    """bmin_pt/bmax_pt: (N, 3) per-point planes OR 3-tuples of (N,)
    per-axis vectors (the node-indexed paths gather per axis)."""

    def unpack(plane, shift):
        p = plane.astype(jnp.uint32)
        return (
            ((p >> 0) & MASK).astype(jnp.uint32) << shift,
            ((p >> 10) & MASK).astype(jnp.uint32) << shift,
            ((p >> 20) & MASK).astype(jnp.uint32) << shift,
        )

    x4, y4, z4 = unpack(xyz4, 20)
    x8, y8, z8 = unpack(xyz8, 10)
    x12, y12, z12 = unpack(xyz12, 0)

    lvl = level_pt
    if not isinstance(bmin_pt, tuple):
        bmin_pt = (bmin_pt[:, 0], bmin_pt[:, 1], bmin_pt[:, 2])
        bmax_pt = (bmax_pt[:, 0], bmax_pt[:, 1], bmax_pt[:, 2])
    box = tuple(a - b for a, b in zip(bmax_pt, bmin_pt))
    # level 0: 30 bits; level 1: 20 bits; else 10 bits
    X = jnp.where(lvl == 0, x4 | x8 | x12, jnp.where(lvl == 1, x4 | x8, x4))
    Y = jnp.where(lvl == 0, y4 | y8 | y12, jnp.where(lvl == 1, y4 | y8, y4))
    Z = jnp.where(lvl == 0, z4 | z8 | z12, jnp.where(lvl == 1, z4 | z8, z4))
    # <= 10-bit level divides by STEPS_10BIT of the *top* plane value
    denom = jnp.where(lvl >= 2, STEPS_10BIT, STEPS_30BIT)
    Xs = jnp.where(lvl >= 2, X >> 20, X).astype(jnp.float32)
    Ys = jnp.where(lvl >= 2, Y >> 20, Y).astype(jnp.float32)
    Zs = jnp.where(lvl >= 2, Z >> 20, Z).astype(jnp.float32)
    px_ = Xs * (box[0] / denom) + bmin_pt[0]
    py_ = Ys * (box[1] / denom) + bmin_pt[1]
    pz_ = Zs * (box[2] / denom) + bmin_pt[2]

    t = transform.astype(jnp.float32)
    cx = t[0, 0] * px_ + t[0, 1] * py_ + t[0, 2] * pz_ + t[0, 3]
    cy = t[1, 0] * px_ + t[1, 1] * py_ + t[1, 2] * pz_ + t[1, 3]
    w = t[3, 0] * px_ + t[3, 1] * py_ + t[3, 2] * pz_ + t[3, 3]
    ndc_x = cx / w
    ndc_y = cy / w
    ok = (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    if mask_pt is not None:
        ok &= mask_pt
    sx = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    sy = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    size = width * height
    pid = jnp.where(ok, sx + sy * width, size)
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)
    payload = (base_index + jnp.arange(xyz4.shape[0])).astype(jnp.uint32)
    return pid, depth, payload


@partial(jax.jit, static_argnames=("width", "height"))
def resolve_indexed(fb_p, rgba, width: int, height: int):
    """Color lookup by winning point index (compute_loop_las/resolve.cs)."""
    color = rgba[jnp.clip(fb_p, 0, rgba.shape[0] - 1)]
    img = jnp.where(fb_p != EMPTY, color, jnp.uint32(0x00443322))
    return img.reshape(height, width)


class ComputeLoopLas(Method):
    def __init__(self, renderer, las, name="loop_las"):
        self.name = name
        self.description = "10-10-10 adaptive precision (2022 paper path)"
        self.group = "10-10-10 bit"
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
        B = las.num_batches_loaded
        if B == 0:
            return resolve(fb_p, W, H)

        cam = renderer.camera
        view, proj = cam.view(), cam.proj()
        wvp = (proj @ view).astype(np.float32)
        bmin, bmax = las.bbox_min[:B], las.bbox_max[:B]
        if Debug.frustum_culling_enabled and Debug.update_frustum:
            vis = batches_in_frustum(frustum_planes(proj @ view), bmin, bmax)
        else:
            vis = np.ones(B, bool)
        level = precision_levels(view, proj, bmin, bmax, W, H)

        n_pad = las.dev["xyz4"].shape[0]
        nb_pad = n_pad // POINTS_PER_WORKGROUP
        lvl_full = np.zeros(nb_pad, np.int32)
        lvl_full[:B] = level
        vis_full = np.zeros(nb_pad, bool)
        vis_full[:B] = vis
        lvl_pt = jnp.asarray(np.repeat(lvl_full, POINTS_PER_WORKGROUP))
        vis_pt = jnp.asarray(np.repeat(vis_full, POINTS_PER_WORKGROUP))
        bmin_full = np.zeros((nb_pad, 3), np.float32)
        bmax_full = np.zeros((nb_pad, 3), np.float32)
        bmin_full[:B] = bmin
        bmax_full[:B] = bmax
        bmin_pt = jnp.asarray(np.repeat(bmin_full, POINTS_PER_WORKGROUP, axis=0))
        bmax_pt = jnp.asarray(np.repeat(bmax_full, POINTS_PER_WORKGROUP, axis=0))
        t = jnp.asarray(wvp)

        d = las.dev
        for s in range(0, n_pad, CHUNK_PTS):
            sl = slice(s, s + CHUNK_PTS)
            fb_d, fb_p = raster_chunk_101010(
                d["xyz4"][sl], d["xyz8"][sl], d["xyz12"][sl],
                lvl_pt[sl], bmin_pt[sl], bmax_pt[sl], t,
                jnp.uint32(s), fb_d, fb_p, W, H, vis_pt[sl],
            )
        renderer.last_fb = (fb_d, fb_p)
        return resolve_indexed(fb_p, d["rgba"], W, H)


class ComputeLoopLas2(ComputeLoopLas):
    """Alias of loop_las (see module docstring on why)."""

    def __init__(self, renderer, las):
        super().__init__(renderer, las, name="loop_las2")
        self.description = "10-10-10 adaptive precision (las2 alias)"


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=(8, 9, 10, 11))
def hqs_chunk_101010(
    xyz4, xyz8, xyz12, level_pt, bmin_pt, bmax_pt, rgba, transform,
    acc_r, acc_g, acc_b, acc_n, fb_depth, width: int, height: int,
    mask_pt=None,
):
    """HQS accumulate pass over packed 10-10-10 points
    (modules/compute_loop_las_hqs/color.cs:370-403 semantics)."""
    pid, depth, _idx = _project_101010(
        xyz4, xyz8, xyz12, level_pt, bmin_pt, bmax_pt, transform, 0,
        width, height, mask_pt,
    )
    return hqs_accumulate((acc_r, acc_g, acc_b, acc_n), pid, depth, rgba,
                          fb_depth)


class ComputeLoopLasHqs(ComputeLoopLas):
    """HQS over the 10-10-10 format (modules/compute_loop_las_hqs)."""

    def __init__(self, renderer, las):
        super().__init__(renderer, las, name="loop_las_hqs")
        self.description = "10-10-10 adaptive precision, HQS average blend"

    def render(self, renderer):
        las = self.las
        las.process(renderer)
        W, H = renderer.width, renderer.height
        if las.num_batches_loaded == 0:
            return jnp.full((H, W), jnp.uint32(0x00443322))

        # depth pass via the base method (fills renderer.last_fb)
        super().render(renderer)
        fb_depth, _ = renderer.last_fb

        cam = renderer.camera
        view, proj = cam.view(), cam.proj()
        wvp = jnp.asarray((proj @ view).astype(np.float32))
        B = las.num_batches_loaded
        bmin, bmax = las.bbox_min[:B], las.bbox_max[:B]
        if Debug.frustum_culling_enabled and Debug.update_frustum:
            vis = batches_in_frustum(frustum_planes(proj @ view), bmin, bmax)
        else:
            vis = np.ones(B, bool)
        level = precision_levels(view, proj, bmin, bmax, W, H)

        n_pad = las.dev["xyz4"].shape[0]
        nb_pad = n_pad // POINTS_PER_WORKGROUP
        lvl_full = np.zeros(nb_pad, np.int32)
        lvl_full[:B] = level
        vis_full = np.zeros(nb_pad, bool)
        vis_full[:B] = vis
        lvl_pt = jnp.asarray(np.repeat(lvl_full, POINTS_PER_WORKGROUP))
        vis_pt = jnp.asarray(np.repeat(vis_full, POINTS_PER_WORKGROUP))
        bmin_full = np.zeros((nb_pad, 3), np.float32)
        bmax_full = np.zeros((nb_pad, 3), np.float32)
        bmin_full[:B] = bmin
        bmax_full[:B] = bmax
        bmin_pt = jnp.asarray(np.repeat(bmin_full, POINTS_PER_WORKGROUP, axis=0))
        bmax_pt = jnp.asarray(np.repeat(bmax_full, POINTS_PER_WORKGROUP, axis=0))

        size = W * H
        acc = [jnp.zeros((size,), jnp.uint32) for _ in range(4)]
        d = las.dev
        for s in range(0, n_pad, CHUNK_PTS):
            sl = slice(s, s + CHUNK_PTS)
            acc = list(
                hqs_chunk_101010(
                    d["xyz4"][sl], d["xyz8"][sl], d["xyz12"][sl],
                    lvl_pt[sl], bmin_pt[sl], bmax_pt[sl], d["rgba"][sl], wvp,
                    *acc, fb_depth, W, H, vis_pt[sl],
                )
            )
        renderer.last_fb = (fb_depth, acc[3])
        return resolve_hqs(*acc, W, H)
