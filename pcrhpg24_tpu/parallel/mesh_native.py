"""Multi-device FLAGSHIP rendering: dp-sharded fbatch frames over a mesh.

The reference is single-GPU; its flagship kernel launch
(modules/huffman_mem_iter_cuda/huffman_mem_iter_cuda.h:192-195) maps to
data-parallel batches over a mesh of devices.  Unlike the reference-
format path (parallel/mesh.py, flat byte streams that need host
re-splitting), the `.tpc` device layout is already per-batch rows, so
sharding is just `PartitionSpec("dp")` on axis 0 of every array:

* each `dp` device decodes, projects with the batch-relative
  f64-folded translations, run-collapses, and min-merges ITS batches
  into a full local framebuffer with exact u64 (depth<<32|payload)
  semantics — payloads are BC1 colors, identical from any shard, so
  winners are device-count-invariant;
* local planes combine with a lexicographic (depth, payload) min
  across `dp` — two `pmin` collectives; exact because u64-min is
  associative over any partition of the entries;
* the `sp` axis shards the final unswizzle+resolve by framebuffer rows.

HQS (reference: modules/huffman_hqs/) shards the same way: the min-depth
plane pmin-combines across dp, the tolerance-gated (r,g,b,count) sums
psum-combine (sums are associative over any partition), and the divide
resolve runs on sp row slices.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import POINTS_PER_THREAD
from ..render.raster import (
    EMPTY,
    hqs_accumulate,
    merge_u64_min,
    resolve,
    resolve_hqs,
    swizzle_dims,
    unswizzle_plane,
)

# dev-dict arrays sharded over dp (axis 0 = batch)
_DEV_SPEC_KEYS = (
    "widths", "streams", "ptrs", "starts", "colors", "anchor", "bbox_min",
    "bbox_max",
)


def _local_chunks(dev, frame_params, scale, offset_rel, tb, width, height,
                  mode, points, fmt, chunk):
    """One shard's frame setup -> (lod_n, nchunks, chunk, chunk_points).

    chunk_points(c) decodes + projects the shard's chunk c (swizzled
    pids).  Chunks tile the shard's batches exactly: the default chunk is
    the largest power-of-two divisor of the shard's batch count, capped
    at the flagship's CHUNK.
    """
    from ..render.methods.huffman_tpu import (
        CHUNK, frame_lod, render_chunk_native,
    )

    B_loc = dev["anchor"].shape[0]
    ck = chunk or math.gcd(B_loc, CHUNK)
    if B_loc % ck:
        raise ValueError(f"chunk {ck} does not divide {B_loc} batches")
    dp_idx = jax.lax.axis_index("dp")
    # real (unpadded) batches of THIS shard: global ids [dp_idx*B_loc, ..)
    nb_local = jnp.clip(frame_params[23].astype(jnp.int32) - dp_idx * B_loc,
                        0, B_loc)
    lod_n, transform = frame_lod(dev, frame_params, width, height, True,
                                 points, n_loaded=nb_local)

    def chunk_points(c):
        pid, dep, pay = render_chunk_native(
            dev, c * ck, transform, lod_n, scale, offset_rel,
            width, height, mode, points, fmt, tb, nbatches=ck,
        )
        return pid.astype(jnp.int32), dep, pay

    return lod_n, B_loc // ck, ck, chunk_points


def _pmin_u64(fb_d, fb_p, axis):
    """Exact lexicographic (depth, payload) min across a mesh axis."""
    d_min = jax.lax.pmin(fb_d, axis)
    cand = jnp.where(fb_d == d_min, fb_p, EMPTY)
    return d_min, jax.lax.pmin(cand, axis)


def make_flagship_render(mesh: Mesh, width: int, height: int,
                         points: int = POINTS_PER_THREAD,
                         fmt: str = "fixed", chunk: int | None = None):
    """Sharded color frame over the flagship fbatch pipeline.

    Call with a NativeLasData-style dev dict (keys _DEV_SPEC_KEYS) whose
    batch count divides by dp.  Returns the (height, width)
    u32 image, row-sharded over `sp`.
    """
    sp = mesh.shape["sp"]
    if height % sp != 0:
        raise ValueError(f"height {height} not divisible by sp {sp}")

    def step(dev, frame_params, scale, offset_rel, tb):
        from ..render.methods.huffman_tpu import live_chunk_loop

        lod_n, nchunks, ck, chunk_points = _local_chunks(
            dev, frame_params, scale, offset_rel, tb, width, height,
            "color", points, fmt, chunk,
        )
        size = swizzle_dims(width, height)[2]
        empty = jnp.full((size,), EMPTY, jnp.uint32)
        fb_d, fb_p = live_chunk_loop(
            lod_n, nchunks, ck,
            lambda c, fb: merge_u64_min(*fb, *chunk_points(c)),
            (empty, empty))
        _dmin, p_min = _pmin_u64(fb_d, fb_p, "dp")
        lin = unswizzle_plane(p_min, width, height)
        rows = height // sp
        sp_idx = jax.lax.axis_index("sp")
        sl = jax.lax.dynamic_slice_in_dim(lin, sp_idx * rows * width,
                                          rows * width)
        return resolve(sl, width, rows)

    dev_spec = {k: P("dp") for k in _DEV_SPEC_KEYS}
    rep = P()
    return jax.shard_map(
        step, mesh=mesh,
        in_specs=(dev_spec, rep, rep, rep, P("dp")),
        out_specs=P("sp", None),
        check_vma=False,
    )


def make_flagship_hqs(mesh: Mesh, width: int, height: int,
                      points: int = POINTS_PER_THREAD,
                      fmt: str = "fixed", chunk: int | None = None):
    """Sharded HQS frame (prepass + tolerance blend + divide resolve).

    Single shard_map program: local depth prepass -> dp pmin -> local
    tolerance-gated sums against the GLOBAL depth plane -> dp psum ->
    sp-sliced divide.
    """
    sp = mesh.shape["sp"]
    if height % sp != 0:
        raise ValueError(f"height {height} not divisible by sp {sp}")

    def step(dev, frame_params, scale, offset_rel, tb):
        from ..render.methods.huffman_tpu import live_chunk_loop

        lod_n, nchunks, ck, chunk_points = _local_chunks(
            dev, frame_params, scale, offset_rel, tb, width, height,
            "hqs", points, fmt, chunk,
        )
        size = swizzle_dims(width, height)[2]

        def depth_pass(c, fbd):
            pid, dep, _rgba = chunk_points(c)
            return fbd.at[pid].min(dep, mode="drop")

        fb_depth = jax.lax.pmin(live_chunk_loop(
            lod_n, nchunks, ck, depth_pass,
            jnp.full((size,), EMPTY, jnp.uint32)), "dp")
        zeros = jnp.zeros((size,), jnp.uint32)
        acc_r, acc_g, acc_b, acc_n = live_chunk_loop(
            lod_n, nchunks, ck,
            lambda c, acc: hqs_accumulate(acc, *chunk_points(c), fb_depth),
            (zeros,) * 4)
        acc_r = jax.lax.psum(acc_r, "dp")
        acc_g = jax.lax.psum(acc_g, "dp")
        acc_b = jax.lax.psum(acc_b, "dp")
        acc_n = jax.lax.psum(acc_n, "dp")

        rows_n = height // sp
        sp_idx = jax.lax.axis_index("sp")
        sl = lambda a: jax.lax.dynamic_slice_in_dim(
            unswizzle_plane(a, width, height), sp_idx * rows_n * width,
            rows_n * width)
        return resolve_hqs(sl(acc_r), sl(acc_g), sl(acc_b), sl(acc_n),
                           width, rows_n)

    dev_spec = {k: P("dp") for k in _DEV_SPEC_KEYS}
    rep = P()
    return jax.shard_map(
        step, mesh=mesh,
        in_specs=(dev_spec, rep, rep, rep, P("dp")),
        out_specs=P("sp", None),
        check_vma=False,
    )
