"""Pallas-Triton kernel: fbatch (fixed-width, `.tpc` v2) geometry decode.

One program decodes one 128-chain group of one batch, one chain per
thread, with the chain's 4-word bit window held in registers for all
`points` steps — the reference's own decode design (one chain per
thread, render.cu:428-466).  The XLA decoder (native_decode_xla.
decode_fixed_xla) runs the same protocol as a 64-step device loop whose
window round-trips through device memory between steps.

Per step i, with the chain's fixed bits per point Wb:
  cnt  = ceil((i+1)Wb/32) - ceil(iWb/32)   words this chain takes (0..3)
  rank = exclusive prefix sum of cnt over the group's 128 lanes
and the chain's new words sit at ptrs[i] + rank + j, j < cnt, of its
group stream (codec/fixed.py documents the layout).  The stream is
padded with 4 zero tiles, so the three candidate loads never leave it.

Output layout matches decode_fixed_xla: (B, points, 3, 8, 128) i32
absolute coordinates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..constants import POINTS_PER_THREAD, TPU_GROUP_SIZE, TPU_GROUPS_PER_BATCH

G = TPU_GROUPS_PER_BATCH  # 8 groups per batch
LANES = TPU_GROUP_SIZE  # 128 chains per group

_U = jnp.uint32
_I = jnp.int32


def _sel4(k, a, b, c, d):
    """Per-lane 4-way select by k in {0,1,2,3}."""
    return jnp.where(k < 2, jnp.where(k == 0, a, b), jnp.where(k == 2, c, d))


def _extract(win, off, w):
    """Bits [off, off+w) of the 128-bit window (w <= 32) -> u32."""
    w0, w1, w2, w3 = win
    word = off >> 5  # 0..2
    sh = (off & 31).astype(_U)
    lo = _sel4(word, w0, w1, w2, w2)
    hi = _sel4(word, w1, w2, w3, w3)
    top = (lo << sh) | ((hi >> _U(1)) >> (_U(31) - sh))
    v = top >> ((_I(32) - w) & 31).astype(_U)
    return jnp.where(w > 0, v, _U(0))


def _unzigzag(z):
    return (z >> _U(1)).astype(_I) ^ -(z & _U(1)).astype(_I)


def _decode_kernel(ptr_ref, width_ref, stream_ref, start_ref, out_ref, *,
                   points: int):
    b = pl.program_id(0)
    g = pl.program_id(1)
    lanes = pl.ds(0, LANES)
    wx = width_ref[b, 0, g, lanes]
    wy = width_ref[b, 1, g, lanes]
    wz = width_ref[b, 2, g, lanes]
    wb = wx + wy + wz  # bits per point, <= 96

    def step(i, carry):
        w0, w1, w2, w3, px, py, pz = carry
        bits = i * wb
        bp = bits & 31
        fi = (bits + 31) >> 5
        ve = fi - (bits >> 5)  # valid words in the window before refill
        cnt = ((bits + wb + 31) >> 5) - fi
        idx0 = ptr_ref[b, 0, i] + jnp.cumsum(cnt) - cnt
        for j in range(3):
            idx = idx0 + j
            vj = stream_ref[b, idx >> 7, g, idx & (LANES - 1)]
            take = cnt > j
            slot = ve + j
            w0 = jnp.where(take & (slot == 0), vj, w0)
            w1 = jnp.where(take & (slot == 1), vj, w1)
            w2 = jnp.where(take & (slot == 2), vj, w2)
            w3 = jnp.where(take & (slot == 3), vj, w3)
        win = (w0, w1, w2, w3)
        px = px + _unzigzag(_extract(win, bp, wx))
        py = py + _unzigzag(_extract(win, bp + wx, wy))
        pz = pz + _unzigzag(_extract(win, bp + wx + wy, wz))
        out_ref[b, i, 0, g, lanes] = px
        out_ref[b, i, 1, g, lanes] = py
        out_ref[b, i, 2, g, lanes] = pz
        k = (bp + wb) >> 5  # words consumed this step
        return (_sel4(k, w0, w1, w2, w3), _sel4(k, w1, w2, w3, w3),
                jnp.where(k == 0, w2, w3), w3, px, py, pz)

    zu = jnp.zeros((LANES,), _U)
    init = (zu, zu, zu, zu, start_ref[b, 0, g, lanes],
            start_ref[b, 1, g, lanes], start_ref[b, 2, g, lanes])
    jax.lax.fori_loop(0, points, step, init)


@functools.partial(jax.jit, static_argnames=("points", "interpret"))
def decode_fixed_triton(widths, streams, ptrs, starts,
                        points: int = POINTS_PER_THREAD,
                        interpret: bool = False):
    """Same signature and layout as native_decode_xla.decode_fixed_xla.

    widths (B,3,8,128) i32, streams (B,maxT,8,128) u32, ptrs (B,1,64)
    i32, starts (B,3,8,128) i32 -> (B, points, 3, 8, 128) i32.
    `points` < 64 decodes the first `points` of every chain (the LOD
    bucket).  `interpret` is for tests on hosts without a GPU.
    """
    B = streams.shape[0]
    return pl.pallas_call(
        functools.partial(_decode_kernel, points=points),
        grid=(B, G),
        out_shape=jax.ShapeDtypeStruct((B, points, 3, G, LANES), jnp.int32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="decode_fixed_triton",
    )(ptrs, widths, streams.astype(_U), starts)
