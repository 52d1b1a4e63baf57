"""`parametric` — procedurally generated point surfaces, no resource.

Replicates modules/compute_parametric: points are evaluated in-kernel
from parametric surface functions (sphere / funky plots) on a (u, v)
grid, then rasterized through the same depth-test framebuffer.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...engine.method import Method
from ..raster import resolve, scatter_u64_min

N_U, N_V = 2048, 1024  # 2M generated points per frame


def sphere(u, v):
    theta = u * 2 * jnp.pi
    phi = (v - 0.5) * jnp.pi
    r = 10.0
    return (
        r * jnp.cos(phi) * jnp.cos(theta),
        r * jnp.cos(phi) * jnp.sin(theta),
        r * jnp.sin(phi),
    )


def wave(u, v):
    x = (u - 0.5) * 40
    y = (v - 0.5) * 40
    z = 3.0 * jnp.sin(0.5 * x) * jnp.cos(0.5 * y)
    return x, y, z


SURFACES = {"sphere": sphere, "wave": wave}


@partial(jax.jit, static_argnames=("surface", "width", "height"))
def render_parametric(transform, surface: str, width: int, height: int):
    u = (jnp.arange(N_U) + 0.5) / N_U
    v = (jnp.arange(N_V) + 0.5) / N_V
    uu, vv = jnp.meshgrid(u, v, indexing="ij")
    fx, fy, fz = SURFACES[surface](uu.reshape(-1), vv.reshape(-1))

    # colorful UV shading
    r = (uu.reshape(-1) * 255).astype(jnp.uint32)
    g = (vv.reshape(-1) * 255).astype(jnp.uint32)
    b = ((fz - fz.min()) / (fz.max() - fz.min() + 1e-9) * 255).astype(jnp.uint32)
    rgba = r | (g << 8) | (b << 16)

    t = transform.astype(jnp.float32)
    cx = t[0, 0] * fx + t[0, 1] * fy + t[0, 2] * fz + t[0, 3]
    cy = t[1, 0] * fx + t[1, 1] * fy + t[1, 2] * fz + t[1, 3]
    w = t[3, 0] * fx + t[3, 1] * fy + t[3, 2] * fz + t[3, 3]
    ndc_x, ndc_y = cx / w, cy / w
    ok = (w > 0) & (jnp.abs(ndc_x) <= 1) & (jnp.abs(ndc_y) <= 1)
    sx = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    sy = ((ndc_y * 0.5 + 0.5) * height).astype(jnp.int32)
    ok &= (sx >= 0) & (sx < width) & (sy >= 0) & (sy < height)
    size = width * height
    pid = jnp.where(ok, sx + sy * width, size)
    depth = jax.lax.bitcast_convert_type(w, jnp.uint32)
    return scatter_u64_min(pid, depth, rgba, size)


class Parametric(Method):
    def __init__(self, renderer, surface: str = "sphere"):
        self.name = "parametric"
        self.description = f"procedural {surface} point surface"
        self.group = "none"
        self.surface = surface
        self.renderer = renderer

    def update(self, renderer):
        pass

    def render(self, renderer):
        W, H = renderer.width, renderer.height
        cam = renderer.camera
        wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
        fb_d, fb_p = render_parametric(wvp, self.surface, W, H)
        renderer.last_fb = (fb_d, fb_p)
        return resolve(fb_p, W, H)
