"""Gather-free BC1 decode for batch point layouts.

BC1 blocks hold 16 *consecutive* points of a chain, so for the batch
layouts used here the block words needed by point (lane, i) are an
affine function of the indices — a reshape + broadcast, never a gather,
which XLA fuses into the projection.

Layouts:
* native decoder layout (C, 64, 8, 128): local id = (g*128+l)*64 + i,
  block = (g*128+l)*4 + i//16 -> colors reshaped (C, 8, 128, 4, 2).
* reference layout (C, 1024, 64): block = lane*4 + i//16.
"""

from __future__ import annotations

import jax.numpy as jnp


def _palette_select(w0, w1, sel_shift):
    """w0/w1 broadcastable block words; sel_shift: per-element selector
    shift (2*(i%16)).  Returns u32 R|G<<8|B<<16 (render.cu:23-65 math)."""
    c0 = w0 & 0xFFFF
    c1 = w0 >> 16

    def expand(c):
        r5 = (c >> 11) & 31
        g6 = (c >> 5) & 63
        b5 = c & 31
        return (
            (r5 << 3) | (r5 >> 2),
            (g6 << 2) | (g6 >> 4),
            (b5 << 3) | (b5 >> 2),
        )

    r0, g0, b0 = expand(c0)
    r1, g1, b1 = expand(c1)
    sel = (w1 >> sel_shift) & 3

    def chan(a, b):
        return jnp.select(
            [sel == 0, sel == 1, sel == 2],
            [a, b, (a * 2 + b) // 3],
            (a + b * 2) // 3,
        )

    return chan(r0, r1) | (chan(g0, g1) << 8) | (chan(b0, b1) << 16)


def bc1_payload_native(colors, shape, points: int = 64):
    """colors (C, 8192) u32 -> payload (C, points, 8, 128) u32 for the
    native kernel point layout (points <= 64: LOD-bucketed decode)."""
    C = colors.shape[0]
    blocks = colors.reshape(C, 8, 128, 4, 2)  # (batch, g, lane, block, word)
    w0 = blocks[..., 0]  # (C, 8, 128, 4)
    w1 = blocks[..., 1]
    # point i selects block i//16 (= repeat each block 16x) and
    # selector bits 2*(i%16)
    i = jnp.arange(points)
    w0p = jnp.repeat(w0, 16, axis=-1)[..., :points]  # (C, 8, 128, points)
    w1p = jnp.repeat(w1, 16, axis=-1)[..., :points]
    sel_shift = (2 * (i % 16)).astype(jnp.uint32)[None, None, None, :]
    pay = _palette_select(
        w0p.astype(jnp.uint32), w1p.astype(jnp.uint32), sel_shift
    )
    return jnp.transpose(pay, (0, 3, 1, 2))  # (C, 64, 8, 128)


def bc7_payload_native(colors, shape, points: int = 64):
    """colors (C, 16384) u32 BC7-mode-6 blocks (4 words each) -> payload
    (C, points, 8, 128) u32 for the native kernel point layout.

    Field extraction mirrors the reference GPU decoder render.cu:122-154
    (see codec/bc7.py for the bit layout and the anchor-index quirk);
    weights compute arithmetically as (idx*128 + 15) // 30 ==
    round(idx*64/15) — exact for idx 0..15, no 16-entry gather."""
    C = colors.shape[0]
    blocks = colors.reshape(C, 8, 128, 4, 4).astype(jnp.uint32)
    i = jnp.arange(points)
    rep = lambda q: jnp.repeat(blocks[..., q], 16, axis=-1)[..., :points]
    w0, w1, w2, w3 = rep(0), rep(1), rep(2), rep(3)
    p0 = w1 >> 31
    p1 = w2 & 1
    r0 = (((w0 >> 7) & 0x7F) << 1) | p0
    r1 = (((w0 >> 14) & 0x7F) << 1) | p1
    g0 = (((w0 >> 21) & 0x7F) << 1) | p0
    g1 = ((((w0 >> 28) | (w1 << 4)) & 0x7F) << 1) | p1
    b0 = (((w1 >> 3) & 0x7F) << 1) | p0
    b1 = (((w1 >> 10) & 0x7F) << 1) | p1
    j = (i % 16).astype(jnp.uint32)[None, None, None, :]
    idx = jnp.where(j < 8, (w2 >> (4 * j)) & 0xF,
                    (w3 >> (4 * (j - 8))) & 0xF)
    wgt = (idx * 128 + 15) // 30
    iw = 64 - wgt
    r = (r0 * iw + r1 * wgt + 32) >> 6
    g = (g0 * iw + g1 * wgt + 32) >> 6
    b = (b0 * iw + b1 * wgt + 32) >> 6
    pay = (r & 0xFF) | ((g & 0xFF) << 8) | ((b & 0xFF) << 16)
    return jnp.transpose(pay, (0, 3, 1, 2))  # (C, points, 8, 128)


def raw_payload_native(colors, shape, points: int = 64):
    """colors (C, 65536) u32 raw R|G<<8|B<<16 -> payload
    (C, points, 8, 128) u32 (reference COLOR_COMPRESSION=0)."""
    C = colors.shape[0]
    pay = colors.reshape(C, 8, 128, 64)[..., :points] & 0xFFFFFF
    return jnp.transpose(pay, (0, 3, 1, 2))


PAYLOAD_NATIVE = {
    "bc1": bc1_payload_native,
    "bc7": bc7_payload_native,
    "raw": raw_payload_native,
}


def bc1_payload_reference(colors, shape):
    """colors (C, 8192) u32 -> payload (C, 1024, 64) u32 for the
    reference decoder's point layout."""
    C = colors.shape[0]
    blocks = colors.reshape(C, 1024, 4, 2)
    w0 = blocks[..., 0]
    w1 = blocks[..., 1]
    i = jnp.arange(64)
    w0p = jnp.repeat(w0, 16, axis=-1)  # (C, 1024, 64)
    w1p = jnp.repeat(w1, 16, axis=-1)
    sel_shift = (2 * (i % 16)).astype(jnp.uint32)[None, None, :]
    return _palette_select(w0p.astype(jnp.uint32), w1p.astype(jnp.uint32), sel_shift)
