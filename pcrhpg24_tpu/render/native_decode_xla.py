"""XLA decoders for the native `.tpc` formats.

`decode_native_xla` (tbatch, v1) and `decode_fixed_xla` (fbatch, v2) are
protocol-identical to the NumPy mirrors (codec/native.py,
codec/fixed.py) and run on every platform.  `decode_fixed` picks the
fbatch decoder the frame uses.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..constants import POINTS_PER_THREAD, TPU_GROUPS_PER_BATCH, TPU_MAX_CODE_LEN

G = TPU_GROUPS_PER_BATCH
MAXL = TPU_MAX_CODE_LEN
_U = jnp.uint32
_I = jnp.int32


def decode_native_xla(lj, streams, ptrs, dD, lut, starts,
                      points: int = POINTS_PER_THREAD):
    """lj (B,1,32), streams (B,8,maxw) u32, ptrs (B,384,8), dD/lut
    (B,1,128), starts (B,3,8,128) -> (B, points, 3, 8, 128) i32."""
    B, _, maxw = streams.shape
    flat = streams.reshape(-1)  # (B*G*maxw,)
    lane = jnp.arange(128)

    cur = streams[:, :, 0:128]
    nxt = streams[:, :, 128:256]
    bitpos = jnp.zeros((B, G, 128), _I)

    dD_flat = dD.reshape(B, 128)
    lut_flat = lut.reshape(B, 128)
    b_idx = jnp.arange(B)[:, None, None]

    def window_hi(cur, nxt, bitpos):
        hi = cur << bitpos.astype(_U)
        lo = nxt >> jnp.minimum(32 - bitpos, 31).astype(_U)
        return hi | jnp.where(bitpos > 0, lo, _U(0))

    def refill(t, cur, nxt, bitpos):
        need = bitpos >= 32
        bitpos = jnp.where(need, bitpos - 32, bitpos)
        rank = jnp.cumsum(need, axis=2) - need
        ptr_t = jax.lax.dynamic_index_in_dim(ptrs, t, axis=1, keepdims=False)  # (B,G)
        base = (jnp.arange(B)[:, None] * G + jnp.arange(G)[None, :]) * maxw  # (B,G)
        idx = base[:, :, None] + ptr_t[:, :, None] + rank
        val = jnp.take(flat, jnp.clip(idx, 0, flat.shape[0] - 1))
        cur = jnp.where(need, nxt, cur)
        nxt = jnp.where(need, val, nxt)
        return cur, nxt, bitpos

    def decode_symbol(t, cur, nxt, bitpos):
        win12 = (window_hi(cur, nxt, bitpos) >> _U(32 - MAXL)).astype(_I)
        L = jnp.ones_like(win12)
        for j in range(1, MAXL):
            L = L + (win12 >= lj[:, 0, j - 1][:, None, None]).astype(_I)
        code_L = win12 >> jnp.minimum(MAXL - L, MAXL)
        dd = jnp.take_along_axis(dD_flat, L.reshape(B, -1), axis=1).reshape(L.shape)
        sym_idx = jnp.clip(code_L + dd, 0, 127)
        bucket = jnp.take_along_axis(
            lut_flat, sym_idx.reshape(B, -1), axis=1
        ).reshape(L.shape)
        bitpos = bitpos + L
        cur, nxt, bitpos = refill(t, cur, nxt, bitpos)

        e = jnp.maximum(bucket - 1, 0)
        win2 = window_hi(cur, nxt, bitpos)
        extra = (win2 >> (_U(31) - e.astype(_U))) >> _U(1)
        extra = extra & ((_U(1) << e.astype(_U)) - _U(1))
        bitpos = bitpos + e
        cur, nxt, bitpos = refill(t + 1, cur, nxt, bitpos)

        z = jnp.where(bucket == 0, _U(0), (_U(1) << e.astype(_U)) | extra)
        delta = (z >> _U(1)).astype(_I) ^ -((z & _U(1)).astype(_I))
        return delta, cur, nxt, bitpos

    def point_step(carry, i):
        cur, nxt, bitpos, px, py, pz = carry
        t0 = i * 6
        dx, cur, nxt, bitpos = decode_symbol(t0, cur, nxt, bitpos)
        dy, cur, nxt, bitpos = decode_symbol(t0 + 2, cur, nxt, bitpos)
        dz, cur, nxt, bitpos = decode_symbol(t0 + 4, cur, nxt, bitpos)
        px, py, pz = px + dx, py + dy, pz + dz
        return (cur, nxt, bitpos, px, py, pz), jnp.stack([px, py, pz], axis=1)

    init = (cur, nxt, bitpos, starts[:, 0], starts[:, 1], starts[:, 2])
    _, ys = jax.lax.scan(point_step, init, jnp.arange(points))
    # ys: (64, B, 3, G, 128) -> (B, 64, 3, G, 128)
    return jnp.transpose(ys, (1, 0, 2, 3, 4))


def decode_fixed_xla(widths, streams, ptrs, starts,
                     points: int = POINTS_PER_THREAD):
    """XLA decoder for the fbatch (fixed-width, v2) format.

    widths (B,3,8,128) i32, streams (B,maxT,8,128) u32, ptrs (B,1,64)
    i32, starts (B,3,8,128) i32 -> (B, points, 3, 8, 128) i32 absolute
    coords; protocol-identical to codec/fixed.py's mirror.
    """
    B = widths.shape[0]
    wx = widths[:, 0].astype(_I)  # (B, 8, 128)
    wy = widths[:, 1].astype(_I)
    wz = widths[:, 2].astype(_I)
    W = wx + wy + wz
    sflat = jnp.transpose(streams, (0, 2, 1, 3)).reshape(B, G, -1)  # (B,8,T*128)
    nmax = sflat.shape[2]

    def sel3(k, a, b, c):
        return jnp.where(k == 0, a, jnp.where(k == 1, b, c))

    def extract(win, off, w):
        w0, w1, w2, w3 = win
        word = off >> 5
        sh = (off & 31).astype(_U)
        lo = sel3(word, w0, w1, w2)
        hi = sel3(word, w1, w2, w3)
        top = (lo << sh) | ((hi >> _U(1)) >> (_U(31) - sh))
        v = top >> ((_I(32) - w) & 31).astype(_U)
        return jnp.where(w > 0, v, _U(0))

    def step(carry, i):
        w0, w1, w2, w3, bp, ve, bits = carry
        bits_next = bits + W
        cnt = ((bits_next + 31) >> 5) - ((bits + 31) >> 5)
        rank = jnp.cumsum(cnt, axis=-1) - cnt
        ptr = jnp.take(ptrs[:, 0], i, axis=1)[:, None, None]  # (B,1,1)
        idx0 = ptr + rank
        for j in range(3):
            idx = jnp.clip(idx0 + j, 0, nmax - 1)
            vj = jnp.take_along_axis(sflat, idx, axis=2).astype(_U)
            take = cnt > j
            slot = ve + j
            w0 = jnp.where(take & (slot == 0), vj, w0)
            w1 = jnp.where(take & (slot == 1), vj, w1)
            w2 = jnp.where(take & (slot == 2), vj, w2)
            w3 = jnp.where(take & (slot == 3), vj, w3)
        ve = ve + cnt
        win = (w0, w1, w2, w3)
        zx = extract(win, bp, wx)
        zy = extract(win, bp + wx, wy)
        zz = extract(win, bp + wx + wy, wz)
        dx = (zx >> _U(1)).astype(_I) ^ -(zx & _U(1)).astype(_I)
        dy = (zy >> _U(1)).astype(_I) ^ -(zy & _U(1)).astype(_I)
        dz = (zz >> _U(1)).astype(_I) ^ -(zz & _U(1)).astype(_I)
        bpn = bp + W
        k = bpn >> 5
        bp = bpn & 31
        ve = ve - k
        w0n = jnp.where(k == 0, w0, jnp.where(k == 1, w1, jnp.where(k == 2, w2, w3)))
        w1n = jnp.where(k == 0, w1, jnp.where(k == 1, w2, w3))
        w2n = jnp.where(k == 0, w2, w3)
        return (w0n, w1n, w2n, w3, bp, ve, bits_next), (dx, dy, dz)

    zu = jnp.zeros((B, G, 128), _U)
    zi = jnp.zeros((B, G, 128), _I)
    init = (zu, zu, zu, zu, zi, zi, zi)
    _, (dx, dy, dz) = jax.lax.scan(step, init, jnp.arange(points))
    # (points, B, 8, 128) deltas -> absolute coords via cumsum
    d = jnp.stack([dx, dy, dz], axis=2)  # (points, B, 3, 8, 128)
    coords = jnp.cumsum(d, axis=0) + jnp.transpose(
        starts, (0, 1, 2, 3)
    )[None].astype(_I)
    return jnp.transpose(coords, (1, 0, 2, 3, 4))  # (B, points, 3, 8, 128)


def decode_fixed(widths, streams, ptrs, starts,
                 points: int = POINTS_PER_THREAD, impl: str = "kernel"):
    """fbatch decode as the frame runs it.

    impl="kernel": the Pallas-Triton kernel (decode_fixed_triton) where
    the program is lowered for CUDA, decode_fixed_xla on any other
    platform (the kernel compiles only for NVIDIA GPUs).  impl="xla":
    decode_fixed_xla everywhere — the reference the kernel is checked
    against.  Both give the same bits.
    """
    from .decode_fixed_triton import decode_fixed_triton

    args = (widths, streams, ptrs, starts)
    xla = partial(decode_fixed_xla, points=points)
    if impl == "xla":
        return xla(*args)
    if impl != "kernel":
        raise ValueError(f"unknown fbatch decoder {impl!r}")
    return jax.lax.platform_dependent(
        *args, cuda=partial(decode_fixed_triton, points=points), default=xla)
