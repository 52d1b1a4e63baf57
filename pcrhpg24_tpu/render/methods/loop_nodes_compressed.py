"""`loop_nodes_compressed` — per-node variable-bit-width packed coords.

Replicates modules/compute_loop_compress_nodewise: octree nodes carry
bit-packed node-relative fixed-point coordinates whose width depends on
the node's extent; the unpacker handles codes spanning word boundaries
(render.cs:268-320).  Consumes the `.wg` format written by
tools/potree_to_wg.py.

The variable-bit unpack is a per-point two-word window read — a
gather, so this path is a functional baseline (it was an experimental
format in the reference too); the production compressed path is
`huffman_tpu`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...engine.method import Method
from ...engine.resource import Resource, ResourceState
from ...tools.potree_to_wg import read_wg
from ..raster import scatter_u64_min
from .loop_las import resolve_indexed


class WgData(Resource):
    """Whole-file `.wg` resource (the reference streams it via three
    ProgressiveFileBuffers; sizes are modest because it is node-wise)."""

    def __init__(self, path: str):
        self.path = path
        records, words, colors = read_wg(path)
        self.records = records
        self.num_points = int(sum(r[0] for r in records))
        self.num_points_loaded = 0
        self.words_np = words
        self.colors_np = colors
        self.dev = {}

    @classmethod
    def create(cls, path: str):
        return cls(path)

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        n = self.num_points
        # per-point expansion tables
        node_bits = np.concatenate(
            [np.full(r[0], r[1], np.int32) for r in self.records]
        )
        base_bit = np.concatenate(
            [
                np.int64(r[2]) * 32 + np.arange(r[0], dtype=np.int64) * 3 * r[1]
                for r in self.records
            ]
        )
        bmin = np.concatenate(
            [np.broadcast_to(r[4], (r[0], 3)) for r in self.records]
        )
        bmax = np.concatenate(
            [np.broadcast_to(r[5], (r[0], 3)) for r in self.records]
        )
        self.dev = dict(
            words=jnp.asarray(self.words_np),
            colors=jnp.asarray(self.colors_np),
            bits=jnp.asarray(node_bits),
            base_bit=jnp.asarray(base_bit),
            bmin=jnp.asarray(bmin.astype(np.float32)),
            bmax=jnp.asarray(bmax.astype(np.float32)),
        )
        self.num_points_loaded = n
        self.state = ResourceState.LOADED

    def process(self, renderer=None):
        pass

    def unload(self, renderer=None):
        self.dev = {}
        self.num_points_loaded = 0
        self.state = ResourceState.UNLOADED

    def wait_loaded(self, renderer=None):
        self.load(renderer)
        return self


@partial(jax.jit, static_argnames=("width", "height"))
def _render_wg(words, colors, bits, base_bit, bmin, bmax, transform,
               width: int, height: int):
    n = bits.shape[0]
    w64 = words.astype(jnp.uint32)

    def axis_val(axis):
        pos = base_bit + axis * bits.astype(jnp.int64)
        w0 = (pos // 32).astype(jnp.int32)
        off = (pos % 32).astype(jnp.uint32)
        a = jnp.take(w64, w0, mode="clip").astype(jnp.uint32)
        b = jnp.take(w64, w0 + 1, mode="clip").astype(jnp.uint32)
        hi = a << off
        lo = b >> jnp.minimum(jnp.uint32(32) - off, jnp.uint32(31))
        window = hi | jnp.where(off > 0, lo, jnp.uint32(0))
        return window >> (jnp.uint32(32) - bits.astype(jnp.uint32))

    span = jnp.maximum(
        jnp.max(bmax - bmin, axis=1), 1e-12
    )
    steps = (jnp.uint32(1) << bits.astype(jnp.uint32)).astype(jnp.float32)
    fx = axis_val(0).astype(jnp.float32) / steps * span + bmin[:, 0]
    fy = axis_val(1).astype(jnp.float32) / steps * span + bmin[:, 1]
    fz = axis_val(2).astype(jnp.float32) / steps * span + bmin[:, 2]

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
    payload = jnp.arange(n, dtype=jnp.uint32)
    return scatter_u64_min(pid, depth, payload, size)


class ComputeLoopNodesCompressed(Method):
    def __init__(self, renderer, wg):
        self.name = "loop_nodes_compressed"
        self.description = "nodewise variable-bit-width packed coords (wg)"
        self.group = "potree"
        self.wg = wg
        self.renderer = renderer

    def update(self, renderer):
        self.wg.load(renderer)

    def render(self, renderer):
        d = self.wg.dev
        W, H = renderer.width, renderer.height
        if not d:
            return jnp.full((H, W), jnp.uint32(0x00443322))
        cam = renderer.camera
        wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
        fb_d, fb_p = _render_wg(
            d["words"], d["colors"], d["bits"], d["base_bit"], d["bmin"],
            d["bmax"], wvp, W, H,
        )
        renderer.last_fb = (fb_d, fb_p)
        return resolve_indexed(fb_p, d["colors"], W, H)
