"""`loop_nodes` — Potree octree LOD rendering.

Replicates modules/compute_loop_nodes: one unit of work per octree node
(instead of per fixed batch), frustum culling plus the LOD cut — nodes
whose projected bbox is smaller than 80 px are skipped entirely (their
parents' subsampled points already cover those pixels;
compute_loop_nodes/render.cs:211-226, 292-296) — then the standard
10-10-10 node-relative unpack and depth-test raster.  `loop_nodes_hqs`
adds the average-blend second pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...engine.debug import Debug
from ...engine.method import Method, Runtime
from ..camera import batches_in_frustum, frustum_planes
from ..raster import (
    EMPTY, hqs_accumulate, merge_u64_min, resolve, resolve_hqs,
    swizzle_dims, swizzle_plane, unswizzle_plane,
)
from .loop_las import (
    _project_101010, project_101010_planes, raster_chunk_101010_nodes,
    resolve_indexed,
)

CHUNK_PTS = 1 << 24  # 16.7M points per device pass

from functools import partial as _partial


def _scan1d_xor(t):
    """Inclusive XOR scan of a (L,) vector: 4096-wide rows + recursive
    row-total scan when L is large, plain doubling otherwise."""
    L = t.shape[0]
    if L > 4096 and L % 4096 == 0:
        x = t.reshape(L // 4096, 4096)
        s = 1
        while s < 4096:
            x = x ^ jnp.pad(x, ((0, 0), (s, 0)))[:, :4096]
            s *= 2
        texc = jnp.pad(_scan1d_xor(x[:, -1]), (1, 0))[: L // 4096]
        return (x ^ texc[:, None]).reshape(-1)
    s = 1
    while s < L:
        t = t ^ jnp.pad(t, (s, 0))[:L]
        s *= 2
    return t


def _xor_prefix_scan(p):
    """Inclusive XOR prefix scan over a flat i32 plane.

    Lane-width doubling scan: 7 shift+xor passes over the full array
    at width 128, then the (n/128,) row totals scan recursively on
    arrays 128x smaller, and one combine pass.  Written out by hand
    because jax.lax.associative_scan's recursive odd/even lowering
    compiles slowly at millions of elements inside the frame loop.
    """
    n = p.shape[0]
    if n <= 4096 or n % 128:
        return _scan1d_xor(p)
    L = n // 128
    x = p.reshape(L, 128)
    s = 1
    while s < 128:
        x = x ^ jnp.pad(x, ((0, 0), (s, 0)))[:, :128]
        s *= 2
    texc = jnp.pad(_scan1d_xor(x[:, -1]), (1, 0))[:L]
    return (x ^ texc[:, None]).reshape(-1)


def _plane_builder(pos, s, chunk_pts: int):
    """-> plane(deltas, base): one per-point attribute over the chunk
    starting at point s, rebuilt from per-node XOR deltas at `pos`.

    Node ids are sorted, so each attribute is a step function over the
    point axis: scatter each node's XOR-delta at its start position and
    one XOR prefix scan rebuilds the plane BIT-EXACTLY (XOR telescopes
    for f32 bit patterns too, unlike a sum of float deltas).  `base` is
    the value just before the chunk's first point.
    """
    idx = pos - s
    # negative scatter indices WRAP in XLA — clamp them to an
    # out-of-bounds value so mode="drop" really drops them
    idx = jnp.where(idx < 0, chunk_pts, idx)

    def plane(deltas, base):
        p = jnp.zeros((chunk_pts,), jnp.int32).at[idx].add(
            deltas, mode="drop")
        return base ^ _xor_prefix_scan(p)

    return plane


def _chunk_start(c, n_pad: int, chunk_pts: int):
    """Clamped start of chunk c, and the mask of its leading points that
    belong to chunk c-1 (a clamped last chunk overlaps its neighbour;
    HQS sums are not idempotent, so those points render only once)."""
    s = jnp.minimum(c * chunk_pts, n_pad - chunk_pts).astype(jnp.int32)
    own = jnp.arange(chunk_pts, dtype=jnp.int32) >= c * chunk_pts - s
    return s, own


def _f32(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _direct_chunk(g, xyz4, xyz8, xyz12, starts_d, code_delta, bmin_delta,
                  bmax_delta, base_code, base_bmin, base_bmax, wvp, live_idx,
                  width, height, chunk_pts, sval_delta, base_sval,
                  rgba=None):
    """Project the g-th live chunk of the resident points -> swizzled
    (pid, depth, payload); payload is the global point index, or the
    rgba colour when `rgba` is given (HQS)."""
    c = live_idx[g]
    s, own = _chunk_start(c, xyz4.shape[0], chunk_pts)
    sl = lambda a: jax.lax.dynamic_slice(a, (s,), (chunk_pts,))
    plane = _plane_builder(starts_d, s, chunk_pts)
    code_pt = jnp.where(own, plane(code_delta, base_code[c]), 0)
    if sval_delta is not None:
        # per-node prefix point budget (node_budget): only the node's
        # first `take` points stay visible; local index = global index
        # - node start, the node-start plane rebuilt like the others
        sval = plane(sval_delta, base_sval[c])
        gidx = s + jnp.arange(chunk_pts, dtype=jnp.int32)
        code_pt = jnp.where((gidx - sval) < (code_pt >> 4), code_pt, 0)
    bmi = tuple(_f32(plane(bmin_delta[:, k], base_bmin[c, k]))
                for k in range(3))
    bma = tuple(_f32(plane(bmax_delta[:, k], base_bmax[c, k]))
                for k in range(3))
    payload = None if rgba is None else sl(rgba) & jnp.uint32(0xFFFFFF)
    return project_101010_planes(
        sl(xyz4), sl(xyz8), sl(xyz12), code_pt, bmi, bma, wvp,
        s.astype(jnp.uint32), width, height, payload=payload,
    )


@_partial(jax.jit, static_argnames=("width", "height", "chunk_pts"))
def render_frame_nodes(
    xyz4, xyz8, xyz12, starts_d, code_delta, bmin_delta, bmax_delta,
    base_code, base_bmin, base_bmax, wvp,
    live_idx, n_live, width: int, height: int, chunk_pts: int,
    sval_delta=None, base_sval=None,
):
    """Whole steady-state Potree color frame in ONE dispatch.

    A loop over the first `n_live` entries of `live_idx` (chunks holding
    a visible node — the analogue of the reference dispatching
    workgroups only for accepted nodes, compute_loop_nodes.h:150-186),
    each projecting `chunk_pts` resident points node-relative and
    min-merging them into the frame's planes (exact u64 semantics).

    Per-point node attributes rebuild from per-NODE deltas
    (_plane_builder): `starts_d`/`*_delta` carry the per-node start
    positions and deltas; `base_*` carry, per chunk, the value just
    before the chunk's first point.  Returns swizzled (fb_d, fb_p).
    """
    size = swizzle_dims(width, height)[2]
    args = (xyz4, xyz8, xyz12, starts_d, code_delta, bmin_delta,
            bmax_delta, base_code, base_bmin, base_bmax, wvp, live_idx,
            width, height, chunk_pts, sval_delta, base_sval)
    empty = jnp.full((size,), EMPTY, jnp.uint32)
    return jax.lax.fori_loop(
        0, n_live, lambda g, fb: merge_u64_min(*fb, *_direct_chunk(g, *args)),
        (empty, empty))


@_partial(jax.jit, static_argnames=("width", "height", "chunk_pts"))
def render_frame_nodes_hqs(
    xyz4, xyz8, xyz12, rgba, starts_d, code_delta, bmin_delta, bmax_delta,
    base_code, base_bmin, base_bmax, fb_depth_sw, wvp,
    live_idx, n_live, width: int, height: int, chunk_pts: int,
    sval_delta=None, base_sval=None,
):
    """HQS accumulate pass over Potree nodes in ONE dispatch.

    Same loop as render_frame_nodes; each chunk projects with the rgba
    plane as payload and adds its tolerance-gated (r,g,b,count) to the
    sums against the color pass's depth plane (swizzled).  Reference:
    modules/compute_loop_nodes_hqs.
    """
    size = swizzle_dims(width, height)[2]
    args = (xyz4, xyz8, xyz12, starts_d, code_delta, bmin_delta,
            bmax_delta, base_code, base_bmin, base_bmax, wvp, live_idx,
            width, height, chunk_pts, sval_delta, base_sval, rgba)
    zeros = jnp.zeros((size,), jnp.uint32)
    return jax.lax.fori_loop(
        0, n_live,
        lambda g, acc: hqs_accumulate(acc, *_direct_chunk(g, *args),
                                      fb_depth_sw),
        (zeros,) * 4)


# ---------------------------------------------------------------------------
# O(visible) compact frame: gather budgeted node prefixes, render those
# ---------------------------------------------------------------------------
#
# The direct frame costs O(resident): every 16.7M-point chunk holding
# ANY visible node pays full plane reconstruction + projection + resolve
# over all its slots.  With the prefix budget active, the candidate set
# is screen-bounded (~density * covered pixels), so the frame instead
# gathers exactly the budgeted prefixes into a small compact buffer
# (COMPACT_SEG-aligned source segments -> one row-gather per plane) and
# runs the chunk pipeline over THAT.  Frame cost becomes
# O(visible * density) for any resident size.  Reference analogue: the
# GPU dispatches one workgroup per accepted node
# (compute_loop_nodes.h:150-186) — work scales with acceptance, not
# residency.

COMPACT_SEG = 4096
COMPACT_CAP = 1 << 25  # compact buffer capacity (points)


def _compact_chunk(c, xyzc, ev_pos, ev_code, ev_end, ev_off, ev_bmin,
                   ev_bmax, base_ev, wvp, width, height, chunk_pts,
                   rgbac=None):
    """Project compact chunk c -> swizzled (pid, depth, payload);
    payload is the GLOBAL point index, or the rgba colour (HQS)."""
    x4c, x8c, x12c = xyzc
    s, own = _chunk_start(c, x4c.shape[0], chunk_pts)
    sl = lambda a: jax.lax.dynamic_slice(a, (s,), (chunk_pts,))
    plane = _plane_builder(ev_pos, s, chunk_pts)
    code_pt = jnp.where(own, plane(ev_code, base_ev[c, 0]), 0)
    end_pt = plane(ev_end, base_ev[c, 1])
    off_pt = plane(ev_off, base_ev[c, 2])
    gidx = off_pt + s + jnp.arange(chunk_pts, dtype=jnp.int32)
    code_pt = jnp.where(gidx < end_pt, code_pt, 0)
    bmi = tuple(_f32(plane(ev_bmin[:, k], base_ev[c, 3 + k]))
                for k in range(3))
    bma = tuple(_f32(plane(ev_bmax[:, k], base_ev[c, 6 + k]))
                for k in range(3))
    payload = (gidx.astype(jnp.uint32) if rgbac is None
               else sl(rgbac) & jnp.uint32(0xFFFFFF))
    return project_101010_planes(
        sl(x4c), sl(x8c), sl(x12c), code_pt, bmi, bma, wvp,
        jnp.uint32(0), width, height, payload=payload,
    )


@_partial(jax.jit, static_argnames=("width", "height", "chunk_pts", "seg"))
def render_frame_nodes_compact(
    x4, x8, x12, seg_src, ev_pos, ev_code, ev_end, ev_off, ev_bmin,
    ev_bmax, base_ev, wvp, n_live,
    width: int, height: int, chunk_pts: int, seg: int,
):
    """Compact color frame: row-gather the listed source segments, then
    the standard plane-reconstruct + project + resolve over the compact
    buffer only.

    Per-point attributes rebuild from XOR deltas scattered at EVENT
    positions in the compact axis (ev_pos): one event per copied
    segment start (the covering node can change discontinuously
    between non-adjacent segments) plus one per node boundary inside a
    segment, closed by a zero event at the end of coverage.  Events
    carry (code = level<<1|vis, end = node_start + take, off = global -
    compact index, bmin/bmax bit patterns); visibility of a compact
    point is code.vis AND gidx < end, where gidx = compact index + off
    — this masks budget-exceeding points, neighbours copied by segment
    alignment, and the pad tail, all through the one mechanism.  The
    winning payload is the GLOBAL point index, so planes are
    bit-identical to the direct (non-compacted) budgeted frame.
    """
    size = swizzle_dims(width, height)[2]
    g = lambda a: a.reshape(-1, seg)[seg_src].reshape(-1)
    args = ((g(x4), g(x8), g(x12)), ev_pos, ev_code, ev_end, ev_off,
            ev_bmin, ev_bmax, base_ev, wvp, width, height, chunk_pts)
    empty = jnp.full((size,), EMPTY, jnp.uint32)
    return jax.lax.fori_loop(
        0, n_live,
        lambda c, fb: merge_u64_min(*fb, *_compact_chunk(c, *args)),
        (empty, empty))


@_partial(jax.jit, static_argnames=("width", "height", "chunk_pts", "seg"))
def render_frame_nodes_compact_hqs(
    x4, x8, x12, rgba, seg_src, ev_pos, ev_code, ev_end, ev_off, ev_bmin,
    ev_bmax, base_ev, fb_depth_sw, wvp, n_live,
    width: int, height: int, chunk_pts: int, seg: int,
):
    """HQS accumulate over the compact buffer (see
    render_frame_nodes_compact); payload is the compact rgba plane."""
    size = swizzle_dims(width, height)[2]
    g = lambda a: a.reshape(-1, seg)[seg_src].reshape(-1)
    args = ((g(x4), g(x8), g(x12)), ev_pos, ev_code, ev_end, ev_off,
            ev_bmin, ev_bmax, base_ev, wvp, width, height, chunk_pts,
            g(rgba))
    zeros = jnp.zeros((size,), jnp.uint32)
    return jax.lax.fori_loop(
        0, n_live,
        lambda c, acc: hqs_accumulate(acc, *_compact_chunk(c, *args),
                                      fb_depth_sw),
        (zeros,) * 4)


@_partial(jax.jit, static_argnames=("n_pad",))
def _expand_frame_codes(deltas, starts, n_pad: int):
    """Scatter per-node code deltas at node starts, cumsum to per-point."""
    plane = jnp.zeros((n_pad,), jnp.int32).at[starts].add(deltas, mode="drop")
    return jnp.cumsum(plane)


def _node_screen_px(view, proj, bmin, bmax, width, height):
    """Projected screen size (px) per node — the same center+radius
    construction as the reference LOD heuristic (render.cu:350-367)."""
    center = 0.5 * (bmin + bmax)
    radius = np.linalg.norm(bmin - bmax, axis=1)
    ch = np.concatenate([center, np.ones((len(center), 1))], 1)
    vc = ch @ view.T
    ve = vc + np.stack([radius, *([np.zeros_like(radius)] * 3)], 1)
    pc = vc @ proj.T
    pe = ve @ proj.T
    sc = 0.5 * (pc[:, :2] / pc[:, 3:4] + 1) * [width, height]
    se = 0.5 * (pe[:, :2] / pe[:, 3:4] + 1) * [width, height]
    return np.linalg.norm(se - sc, axis=1)


def node_levels(view, proj, bmin, bmax, width, height):
    """Precision level per node; >= 4 culls it (render.cs:205-226)."""
    ps = _node_screen_px(view, proj, bmin, bmax, width, height)
    level = np.zeros(len(ps), np.int32)
    level[ps < 10000] = 1
    level[ps < 500] = 2
    level[ps < 200] = 3
    level[ps < 80] = 4
    return level


# budget value meaning "render every point" (no thinning); fits the
# code's take field (27 usable bits) and exceeds any node's count
TAKE_ALL = 1 << 26


def node_budget(view, proj, bmin, bmax, counts, width, height,
                density: float = 3.0, min_take: int = 256):
    """Per-node point budget: the first `take` of the node's points
    render (a prefix), take chosen so the node's candidate count
    tracks ~density points per covered screen pixel.

    The nodes-path analogue of the flagship's per-batch LOD%
    (huffman_mem_iter_cuda/render.cu:346-379 renders a percentage of
    every thread's points): a node whose projected footprint covers
    ~A pixels caps its rendered points at ~density * A candidates, so
    the per-frame working set is screen-bounded instead of growing
    with how many points the dataset stores per octree node.  Both are
    subsampling LOD heuristics — the image keeps full coverage
    (>= density candidates per covered pixel) but individual depth
    winners may differ from the unbudgeted frame, exactly as the
    reference's LOD slider trades.  A PREFIX is a uniform subsample
    when node points are stored in random order (Potree writers
    insert in scan order which interleaves; see also the builder's
    shuffle) — and, unlike a strided mask, prefixes keep the budget
    compactable by pure slice copies (render_frame_nodes_compact).
    """
    ps = _node_screen_px(view, proj, bmin, bmax, width, height)
    # ps is the projected bbox diagonal; footprint area ~ ps^2 / 2,
    # clipped to the framebuffer (a node spanning the whole screen
    # never needs more than density * W * H candidates)
    area = np.minimum(ps * ps * 0.5, float(width * height))
    take = np.ceil(density * area).astype(np.int64)
    return np.clip(take, min_take, np.maximum(counts, 1)).astype(np.int32)


class ComputeLoopNodes(Method):
    def __init__(self, renderer, potree, name="loop_nodes"):
        self.name = name
        self.description = "Potree octree nodes, 10-10-10 node-relative"
        self.group = "potree"
        self.potree = potree
        self.renderer = renderer
        self._pt_cache = None

    def update(self, renderer):
        if Runtime.resource is not self.potree:
            if Runtime.resource is not None:
                Runtime.resource.unload(renderer)
            self.potree.load(renderer)
            Runtime.resource = self.potree

    def _per_point_tables(self, n_loaded):
        """Per-node device tables, rebuilt once per upload event.

        The frames rebuild per-point node attributes from per-node XOR
        deltas (`*_delta`, `base_*`; see _plane_builder).  `nid_pt` (u32
        node id per point, 4 B/point resident) with the node-indexed
        `bmin_nodes`/`bmax_nodes`/`starts_nodes` tables feeds the eager
        reference (loop_las.raster_chunk_101010_nodes) that the frames
        are tested against — the analogue of the reference's per-node
        uniforms (compute_loop_nodes.h:184-185).
        """
        p = self.potree
        if self._pt_cache is not None and self._pt_cache[0] == n_loaded:
            return self._pt_cache[1]
        counts = p.node_count[: p.nodes_loaded]
        nn = p.nodes_loaded
        cap = len(p.nodes)
        n_pad = int(p.dev["xyz4"].shape[0])
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        # +1 at each node start after the first; +1 past the last point
        # so the pad region gets id `nn` -> code 0 (invisible).  Arrays
        # pad to the FIXED capacity so the jitted scatter+cumsum
        # compiles once, not once per streamed bin (unused slots
        # scatter delta 0 — harmless wherever they land).
        deltas = np.zeros(cap + 2, np.int32)
        deltas[1 : nn + 1] = 1
        starts_full = np.zeros(cap + 2, np.int64)
        starts_full[: nn + 1] = starts
        nid_pt = _expand_frame_codes(
            jnp.asarray(deltas), jnp.asarray(starts_full.astype(np.int32)),
            n_pad
        ).astype(jnp.uint32)
        if self._pt_cache is None or self._pt_cache[1]["bmin_nodes"] is None:
            bpad = np.zeros((cap + 1, 3), np.float32)
            bpad[:cap] = p.bbox_min
            bmin_nodes = jnp.asarray(bpad)
            bpad2 = np.zeros((cap + 1, 3), np.float32)
            bpad2[:cap] = p.bbox_max
            bmax_nodes = jnp.asarray(bpad2)
        else:
            bmin_nodes = self._pt_cache[1]["bmin_nodes"]
            bmax_nodes = self._pt_cache[1]["bmax_nodes"]
        # gather-free attribute reconstruction (_plane_builder):
        # per-node XOR-deltas scattered at node starts + an XOR prefix
        # scan rebuild per-point attribute planes bit-exactly; unused
        # capacity slots park their start at n_pad (out of every
        # chunk's range), and a sentinel delta at the total-points
        # position zeroes attributes over the pad region.
        cap2 = cap + 2
        starts_dv = np.full(cap2, n_pad, np.int64)
        starts_dv[: nn + 1] = starts

        def xor_deltas(bits):  # (nn, 3) i32 -> (cap2, 3)
            d = np.zeros((cap2, 3), np.int32)
            if nn:
                d[0] = bits[0]
                d[1:nn] = bits[1:] ^ bits[:-1]
                d[nn] = bits[nn - 1]  # ^ value -> 0 past the last point
            return d

        bbits_min = np.ascontiguousarray(
            p.bbox_min[:nn], np.float32).view(np.int32)
        bbits_max = np.ascontiguousarray(
            p.bbox_max[:nn], np.float32).view(np.int32)
        # per-node first-point index: (a) a gatherable table for the
        # nid paths, (b) XOR deltas so the plane path can rebuild the
        # per-point node-start plane (-> local index for the budget
        # mask) with the same scatter+scan as the other attributes
        sn = np.full(cap + 1, n_pad, np.int64)
        sn[:nn] = starts[:nn]
        s32 = starts[:nn].astype(np.int32)
        sv = np.zeros(cap2, np.int32)
        if nn:
            sv[0] = s32[0]
            sv[1:nn] = s32[1:] ^ s32[:-1]
            sv[nn] = s32[nn - 1]
        chunk_pts = min(CHUNK_PTS, n_pad)
        ncap = (n_pad + chunk_pts - 1) // chunk_pts
        total = int(starts[nn]) if nn else 0
        # per chunk: the node covering the point just before the
        # chunk's (clamped) start — its attribute value is the XOR
        # base for the in-chunk scan
        base_node = np.full(ncap, -1, np.int64)
        for c in range(ncap):
            s_c = min(c * chunk_pts, n_pad - chunk_pts)
            if s_c > 0 and s_c - 1 < total:
                base_node[c] = np.searchsorted(
                    starts, s_c - 1, side="right") - 1

        def base_vals(bits):  # (nn, 3) -> (ncap, 3) i32
            b = np.zeros((ncap, 3), np.int32)
            ok = (base_node >= 0) & (base_node < nn)
            if nn:
                b[ok] = bits[base_node[ok]]
            return b

        base_sval = np.zeros(ncap, np.int32)
        okb = (base_node >= 0) & (base_node < nn)
        if nn:
            base_sval[okb] = s32[base_node[okb]]

        tables = dict(
            nid_pt=nid_pt, bmin_nodes=bmin_nodes, bmax_nodes=bmax_nodes,
            starts=starts,
            starts_d=jnp.asarray(starts_dv.astype(np.int32)),
            starts_nodes=jnp.asarray(sn.astype(np.int32)),
            sval_delta=jnp.asarray(sv),
            base_sval=jnp.asarray(base_sval),
            bmin_delta=jnp.asarray(xor_deltas(bbits_min)),
            bmax_delta=jnp.asarray(xor_deltas(bbits_max)),
            base_bmin=jnp.asarray(base_vals(bbits_min)),
            base_bmax=jnp.asarray(base_vals(bbits_max)),
            base_node=base_node, nn=nn, cap2=cap2,
            chunk_pts=chunk_pts, ncap=ncap,
        )
        self._pt_cache = (n_loaded, tables)
        return tables

    def _frame_code_deltas(self, code, tables):
        """Per-frame (code_delta (cap2,), base_code (ncap,)) arrays for
        the XOR-scan reconstruction (code = level<<1 | vis per node)."""
        nn, cap2 = tables["nn"], tables["cap2"]
        cv = np.asarray(code[:nn], np.int32)
        d = np.zeros(cap2, np.int32)
        if nn:
            d[0] = cv[0]
            d[1:nn] = cv[1:] ^ cv[:-1]
            d[nn] = cv[nn - 1]
        bn = tables["base_node"]
        b = np.zeros(len(bn), np.int32)
        ok = (bn >= 0) & (bn < nn)
        if nn:
            b[ok] = cv[bn[ok]]
        return jnp.asarray(d), jnp.asarray(b)

    def _frame_codes(self, level, vis, cap, take=None):
        """(take<<4 | level<<1 | vis) per node, padded to the fixed
        node capacity.  take (node_budget) is the per-node prefix
        point budget; default TAKE_ALL = render everything."""
        code = (level.astype(np.int32) << 1) | vis.astype(np.int32)
        tv = np.full(len(code), TAKE_ALL, np.int32) if take is None else (
            np.minimum(take.astype(np.int64), TAKE_ALL).astype(np.int32))
        code = code | (tv << 4)
        full = np.zeros(cap + 1, np.int32)
        full[: len(code)] = code
        return jnp.asarray(full)

    def _live_chunks(self, starts, counts, vis, n_pad):
        """Chunk indices containing at least one visible node's points.

        Host-side O(nodes) work; skipped chunks contribute nothing by
        construction (every point in them is masked invisible), so the
        image is identical — the analogue of the reference
        dispatching workgroups only for accepted nodes
        (compute_loop_nodes.h:150-186).
        """
        nchunks = (n_pad + CHUNK_PTS - 1) // CHUNK_PTS
        live = np.zeros(nchunks, bool)
        vis_idx = np.flatnonzero(vis)
        if len(vis_idx):
            c0 = starts[vis_idx] // CHUNK_PTS
            c1 = (starts[vis_idx] + counts[vis_idx] - 1) // CHUNK_PTS
            for a, b in zip(c0, c1):
                live[a : b + 1] = True
        return np.flatnonzero(live)

    def _compact_frame_tables(self, vis, level, take):
        """Per-frame host arrays for the compact O(visible) frame.

        Pure numpy, O(visible nodes + copied segments).  Returns None
        when nothing is visible.  See render_frame_nodes_compact for
        the event semantics.  All returned device arrays have FIXED
        capacities (cap_segs source rows, cap_ev events) so the jitted
        frame compiles once per scene.
        """
        p = self.potree
        nn = p.nodes_loaded
        n_pad = int(p.dev["xyz4"].shape[0])
        SEG = COMPACT_SEG
        cap_pts = min(COMPACT_CAP, n_pad)
        chunk_pts = min(CHUNK_PTS, cap_pts)
        ncap = max(1, -(-cap_pts // chunk_pts))
        cap_pts = ncap * chunk_pts if cap_pts % chunk_pts else cap_pts
        cap_segs = cap_pts // SEG
        counts = p.node_count[:nn].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        t_all = np.minimum(take[:nn].astype(np.int64), counts)
        vi = np.flatnonzero(vis[:nn] & (t_all > 0))
        if len(vi) == 0:
            return None
        s_n = starts[vi]
        t_n = t_all[vi]
        # aligned segment cover of each node's budget prefix; if the
        # cover exceeds the buffer, shrink every take proportionally
        # (the budget is a heuristic — a denser cap is still a valid,
        # screen-bounded LOD)
        # Adjacent nodes share the segment where one ends and the next
        # begins; each source segment is copied ONCE (a second copy
        # would add its points twice to the HQS sums).
        for _ in range(64):
            a0 = s_n // SEG
            a1 = (s_n + t_n - 1) // SEG
            segs = np.unique(np.concatenate(
                [np.arange(a, b + 1) for a, b in zip(a0, a1)]))
            tot = len(segs)
            if tot <= cap_segs:
                break
            t_n = np.maximum(1, t_n * 9 // 10)
        else:
            raise RuntimeError("compact cover does not fit the buffer")
        t_all = t_all.copy()
        t_all[vi] = t_n
        seg_src = np.zeros(cap_segs, np.int32)
        seg_src[:tot] = segs
        A = seg_src[:tot].astype(np.int64) * SEG

        # events: covering node at each segment start + node starts
        # strictly inside each segment, then one closing zero event
        cov = np.searchsorted(starts, A, side="right") - 1
        lo = np.searchsorted(starts[:nn], A, side="right")
        hi = np.searchsorted(starts[:nn], A + SEG, side="left")
        ev_pos, ev_node, ev_segoff = [], [], []
        off_seg = (seg_src[:tot].astype(np.int64) - np.arange(tot)) * SEG
        for j in range(tot):
            ev_pos.append(j * SEG)
            ev_node.append(int(cov[j]))
            ev_segoff.append(int(off_seg[j]))
            for k in range(int(lo[j]), int(hi[j])):
                ev_pos.append(j * SEG + int(starts[k] - A[j]))
                ev_node.append(k)
                ev_segoff.append(int(off_seg[j]))
        ev_pos.append(tot * SEG)
        ev_node.append(-1)  # closing zero event
        ev_segoff.append(0)
        ne = len(ev_pos)
        cap_ev = cap_segs + len(p.nodes) + 2
        assert ne <= cap_ev, (ne, cap_ev)

        # absolute event values -> XOR deltas in event order
        node = np.asarray(ev_node)
        okn = node >= 0
        code_v = np.zeros(ne, np.int32)
        code_v[okn] = ((level[node[okn]].astype(np.int32) << 1)
                       | vis[node[okn]].astype(np.int32))
        end_v = np.zeros(ne, np.int64)
        end_v[okn] = starts[node[okn]] + t_all[node[okn]]
        end_v = end_v.astype(np.int32)
        off_v = np.asarray(ev_segoff, np.int64).astype(np.int32)
        off_v[~okn] = 0
        bmin_v = np.zeros((ne, 3), np.int32)
        bmax_v = np.zeros((ne, 3), np.int32)
        bmin_bits = np.ascontiguousarray(
            p.bbox_min[:nn], np.float32).view(np.int32)
        bmax_bits = np.ascontiguousarray(
            p.bbox_max[:nn], np.float32).view(np.int32)
        bmin_v[okn] = bmin_bits[node[okn]]
        bmax_v[okn] = bmax_bits[node[okn]]

        def to_deltas(v):
            d = np.zeros((cap_ev,) + v.shape[1:], np.int32)
            d[0] = v[0]
            d[1:ne] = v[1:] ^ v[:-1]
            return d

        pos_full = np.full(cap_ev, cap_pts, np.int32)
        pos_full[:ne] = ev_pos
        # per-chunk base = value of the last event at position <= s-1,
        # s = the chunk's CLAMPED start
        base_ev = np.zeros((ncap, 9), np.int32)
        posn = np.asarray(ev_pos)
        vals = [code_v, end_v, off_v] + [bmin_v[:, k] for k in range(3)] \
            + [bmax_v[:, k] for k in range(3)]
        for c in range(ncap):
            s_c = min(c * chunk_pts, cap_pts - chunk_pts)
            if s_c <= 0:
                continue
            e = np.searchsorted(posn, s_c - 1, side="right") - 1
            if e >= 0:
                for q in range(9):
                    base_ev[c, q] = vals[q][e]
        n_live = -(-tot * SEG // chunk_pts)
        return dict(
            seg_src=jnp.asarray(seg_src),
            ev_pos=jnp.asarray(pos_full),
            ev_code=jnp.asarray(to_deltas(code_v)),
            ev_end=jnp.asarray(to_deltas(end_v)),
            ev_off=jnp.asarray(to_deltas(off_v)),
            ev_bmin=jnp.asarray(to_deltas(bmin_v)),
            ev_bmax=jnp.asarray(to_deltas(bmax_v)),
            base_ev=jnp.asarray(base_ev),
            n_live=jnp.int32(n_live), ncap=ncap, chunk_pts=chunk_pts,
            budgeted_pts=int(t_n.sum()), n_segs=tot,
        )

    def _frame_state(self, renderer):
        """Per-frame host work shared by the color and HQS passes:
        -> (wvp, vis, level, take, tables)."""
        p = self.potree
        cam = renderer.camera
        W, H = renderer.width, renderer.height
        view, proj = cam.view(), cam.proj()
        wvp = jnp.asarray((proj @ view).astype(np.float32))
        nn = p.nodes_loaded
        bmin, bmax = p.bbox_min[:nn], p.bbox_max[:nn]
        if Debug.frustum_culling_enabled and Debug.update_frustum:
            vis = batches_in_frustum(frustum_planes(proj @ view), bmin, bmax)
        else:
            vis = np.ones(nn, bool)
        level = node_levels(view, proj, bmin, bmax, W, H)
        vis &= level < 4  # the LOD cut
        take = None
        if Debug.node_budget > 0:
            take = node_budget(view, proj, bmin, bmax, p.node_count[:nn],
                               W, H, density=Debug.node_budget)
        tables = self._per_point_tables(p.num_points_loaded)
        return wvp, vis, level, take, tables

    def _direct_args(self, tables, vis, level):
        """-> (node delta arguments, live_idx, n_live) of the direct
        single-dispatch frame, or None when no chunk is live."""
        p = self.potree
        live = self._live_chunks(
            tables["starts"], p.node_count[: p.nodes_loaded], vis,
            int(p.dev["xyz4"].shape[0]))
        if not len(live):
            return None
        live_idx = np.zeros(tables["ncap"], np.int32)
        live_idx[: len(live)] = live
        code_delta, base_code = self._frame_code_deltas(
            np.asarray(self._frame_codes(level, vis, len(p.nodes))), tables)
        args = (tables["starts_d"], code_delta, tables["bmin_delta"],
                tables["bmax_delta"], base_code, tables["base_bmin"],
                tables["base_bmax"])
        return args, jnp.asarray(live_idx), jnp.int32(len(live))

    def render(self, renderer):
        p = self.potree
        p.process(renderer)
        W, H = renderer.width, renderer.height
        fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
        fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
        if p.num_points_loaded == 0:
            return resolve(fb_p, W, H)

        d = p.dev
        wvp, vis, level, take, tables = self._frame_state(renderer)
        xyz = (d["xyz4"], d["xyz8"], d["xyz12"])
        if take is not None:
            # budgeted O(visible) compact frame: gather the budgeted
            # node prefixes and render only those — frame cost no
            # longer scales with residency
            ct = self._compact_frame_tables(vis, level, take)
            if ct is not None:
                fbd, fbp = render_frame_nodes_compact(
                    *xyz, ct["seg_src"], ct["ev_pos"], ct["ev_code"],
                    ct["ev_end"], ct["ev_off"], ct["ev_bmin"],
                    ct["ev_bmax"], ct["base_ev"], wvp, ct["n_live"],
                    W, H, ct["chunk_pts"], COMPACT_SEG,
                )
                fb_p = unswizzle_plane(fbp, W, H)
                fb_d = unswizzle_plane(fbd, W, H)
        else:
            # whole frame in ONE dispatch over the live chunks (chunk
            # planes combine with an exact u64 min, associative over any
            # partition)
            direct = self._direct_args(tables, vis, level)
            if direct is not None:
                args, live_idx, n_live = direct
                fbd, fbp = render_frame_nodes(
                    *xyz, *args, wvp, live_idx, n_live, W, H,
                    tables["chunk_pts"],
                )
                fb_p = unswizzle_plane(fbp, W, H)
                fb_d = unswizzle_plane(fbd, W, H)
        renderer.last_fb = (fb_d, fb_p)
        return resolve_indexed(fb_p, d["rgba"], W, H)


class ComputeLoopNodesHqs(ComputeLoopNodes):
    """HQS over Potree nodes (modules/compute_loop_nodes_hqs)."""

    def __init__(self, renderer, potree):
        super().__init__(renderer, potree, name="loop_nodes_hqs")
        self.description = "Potree octree nodes, HQS average blend"

    def render(self, renderer):
        p = self.potree
        p.process(renderer)
        W, H = renderer.width, renderer.height
        if p.num_points_loaded == 0:
            return jnp.full((H, W), jnp.uint32(0x00443322))

        super().render(renderer)  # depth pass via parent (fills last_fb)
        fb_d, _ = renderer.last_fb
        fb_depth_sw = swizzle_plane(fb_d, W, H, EMPTY)
        d = p.dev
        wvp, vis, level, take, tables = self._frame_state(renderer)
        xyz = (d["xyz4"], d["xyz8"], d["xyz12"])
        acc = [jnp.zeros((W * H,), jnp.uint32) for _ in range(4)]
        if take is not None:
            # budgeted compact HQS (see render_frame_nodes_compact)
            ct = self._compact_frame_tables(vis, level, take)
            if ct is not None:
                accs = render_frame_nodes_compact_hqs(
                    *xyz, d["rgba"], ct["seg_src"], ct["ev_pos"],
                    ct["ev_code"], ct["ev_end"], ct["ev_off"],
                    ct["ev_bmin"], ct["ev_bmax"], ct["base_ev"],
                    fb_depth_sw, wvp, ct["n_live"],
                    W, H, ct["chunk_pts"], COMPACT_SEG,
                )
                acc = [unswizzle_plane(a, W, H) for a in accs]
        else:
            direct = self._direct_args(tables, vis, level)
            if direct is not None:
                args, live_idx, n_live = direct
                accs = render_frame_nodes_hqs(
                    *xyz, d["rgba"], *args, fb_depth_sw, wvp, live_idx,
                    n_live, W, H, tables["chunk_pts"],
                )
                acc = [unswizzle_plane(a, W, H) for a in accs]
        renderer.last_fb = (fb_d, acc[3])
        return resolve_hqs(*acc, W, H)


# ---------------------------------------------------------------------------
# Eager reference: the same frame the slow, obvious way (tests and the
# chip smoke check the single-dispatch frames against it; no runtime path)
# ---------------------------------------------------------------------------


@_partial(jax.jit, static_argnames=("width", "height"))
def _eager_hqs_step(xyz4, xyz8, xyz12, nid, bmin_nodes, bmax_nodes, codes,
                    rgba, acc, transform, fbd, starts_nodes, base_index,
                    width: int, height: int):
    nidc = jnp.clip(nid, 0, codes.shape[0] - 1).astype(jnp.int32)
    code = codes[nidc]
    local = (base_index + jnp.arange(xyz4.shape[0], dtype=jnp.int32)
             - starts_nodes[nidc])
    vis = ((code & 1) == 1) & (local < (code >> 4))
    bmi = tuple(bmin_nodes[:, k][nidc] for k in range(3))
    bma = tuple(bmax_nodes[:, k][nidc] for k in range(3))
    pid, depth, _idx = _project_101010(
        xyz4, xyz8, xyz12, (code >> 1) & 7, bmi, bma, transform,
        base_index, width, height, vis)
    return hqs_accumulate(acc, pid, depth, rgba, fbd)


def eager_hqs_sums(d, tables, code_nodes, chunks, wvp, fb_d, width, height):
    """HQS (r,g,b,n) sums (linear) over exact CHUNK_PTS slices of the
    listed chunks: node-table gathers + scatter-adds, one call per chunk."""
    n_pad = d["xyz4"].shape[0]
    acc = tuple(jnp.zeros((width * height,), jnp.uint32) for _ in range(4))
    for c in chunks:
        s = int(c) * CHUNK_PTS
        sl = slice(s, min(s + CHUNK_PTS, n_pad))
        acc = _eager_hqs_step(
            d["xyz4"][sl], d["xyz8"][sl], d["xyz12"][sl],
            tables["nid_pt"][sl], tables["bmin_nodes"], tables["bmax_nodes"],
            code_nodes, d["rgba"][sl], acc, wvp, fb_d,
            tables["starts_nodes"], jnp.int32(s), width, height)
    return list(acc)


def eager_reference(method, renderer, hqs: bool = False):
    """The image `method` renders for the renderer's current camera,
    computed eagerly chunk by chunk in linear pixel space, one dispatch
    per chunk (color: u64-min merge; HQS: depth pass + scatter-add
    sums)."""
    p = method.potree
    W, H = renderer.width, renderer.height
    d = p.dev
    wvp, vis, level, take, tables = method._frame_state(renderer)
    codes = method._frame_codes(level, vis, len(p.nodes), take)
    n_pad = int(d["xyz4"].shape[0])
    chunks = method._live_chunks(tables["starts"],
                                 p.node_count[: p.nodes_loaded], vis, n_pad)
    fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
    for c in chunks:
        s = int(c) * CHUNK_PTS
        sl = slice(s, min(s + CHUNK_PTS, n_pad))
        fb_d, fb_p = raster_chunk_101010_nodes(
            d["xyz4"][sl], d["xyz8"][sl], d["xyz12"][sl],
            tables["nid_pt"][sl], tables["bmin_nodes"],
            tables["bmax_nodes"], codes, wvp, jnp.uint32(s), fb_d, fb_p,
            W, H, starts_nodes=tables["starts_nodes"])
    if not hqs:
        return resolve_indexed(fb_p, d["rgba"], W, H)
    acc = eager_hqs_sums(d, tables, codes, chunks, wvp, fb_d, W, H)
    return resolve_hqs(*acc, W, H)
