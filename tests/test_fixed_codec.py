"""fbatch fixed-width codec (`.tpc` v2): round-trip, and the Pallas-
Triton decode kernel (interpret mode here) and the XLA decoder
bit-exact vs the NumPy mirror decoder."""

import numpy as np
import pytest

from pcrhpg24_tpu.codec.fixed import (
    FixedBatch,
    decode_fixed_batch,
    encode_fixed_batch,
)


def _cloud(seed=0, jumps=True):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(-20, 21, (65536, 3)), axis=0)
    if jumps:
        base[::7777] += rng.integers(-100000, 100000, (9, 3))
    return (base[:, i].astype(np.int32) for i in range(3))


def test_roundtrip_exact():
    x, y, z = _cloud(0)
    fb = encode_fixed_batch(x, y, z)
    np.testing.assert_array_equal(
        decode_fixed_batch(fb), np.stack([x, y, z], -1)
    )


def test_roundtrip_fullrange_and_constant():
    rng = np.random.default_rng(1)
    x = rng.integers(-(2**31), 2**31, 65536).astype(np.int32)
    y = rng.integers(-(2**31), 2**31, 65536).astype(np.int32)
    fb = encode_fixed_batch(x, y, x)  # W == 96 worst case
    np.testing.assert_array_equal(decode_fixed_batch(fb), np.stack([x, y, x], -1))
    c = np.full(65536, -7, np.int32)
    fb2 = encode_fixed_batch(c, c, c)
    assert fb2.total_words == 0  # zero-width chains cost nothing
    np.testing.assert_array_equal(decode_fixed_batch(fb2), np.stack([c, c, c], -1))


def _decoded(out, fbs, points):
    out = np.asarray(out)  # (B, points, 3, 8, 128)
    for b, fb in enumerate(fbs):
        ref = decode_fixed_batch(fb).reshape(8, 128, 64, 3)
        got = np.transpose(out[b], (2, 3, 0, 1))  # (8,128,points,3)
        np.testing.assert_array_equal(got, ref[:, :, :points])


@pytest.mark.parametrize("points", [64, 16])
def test_pallas_kernel_matches_mirror(points):
    from pcrhpg24_tpu.codec.fixed import pack_fixed_batches
    from pcrhpg24_tpu.render.decode_fixed_triton import decode_fixed_triton

    fbs = [encode_fixed_batch(*_cloud(s)) for s in (0, 3)]
    packed = pack_fixed_batches(fbs)
    _decoded(decode_fixed_triton(
        packed["widths"], packed["streams"], packed["ptrs"],
        packed["starts"], points=points, interpret=True,
    ), fbs, points)


@pytest.mark.parametrize("impl", ["kernel", "xla"])
@pytest.mark.parametrize("points", [64, 32])
def test_decode_fixed_matches_mirror(points, impl):
    """The frame's decoder entry point, both choices (on a host without
    a GPU, "kernel" lowers to the XLA decoder)."""
    import jax

    from pcrhpg24_tpu.codec.fixed import pack_fixed_batches
    from pcrhpg24_tpu.render.native_decode_xla import decode_fixed

    fbs = [encode_fixed_batch(*_cloud(s, jumps=s == 5)) for s in (5, 6, 7)]
    packed = pack_fixed_batches(fbs)
    out = jax.jit(decode_fixed, static_argnames=("points", "impl"))(
        packed["widths"], packed["streams"], packed["ptrs"],
        packed["starts"], points=points, impl=impl)
    _decoded(out, fbs, points)


def test_decode_kernel_worst_case_widths():
    """96-bit points (full-range deltas) and zero-width chains: the
    refill takes 3 words per step and the stream pad is exercised."""
    from pcrhpg24_tpu.codec.fixed import pack_fixed_batches
    from pcrhpg24_tpu.render.decode_fixed_triton import decode_fixed_triton

    rng = np.random.default_rng(1)
    x = rng.integers(-(2**31), 2**31, 65536).astype(np.int32)
    c = np.full(65536, 5, np.int32)
    fbs = [encode_fixed_batch(x, x[::-1].copy(), x), encode_fixed_batch(c, c, c)]
    packed = pack_fixed_batches(fbs)
    _decoded(decode_fixed_triton(
        packed["widths"], packed["streams"], packed["ptrs"],
        packed["starts"], interpret=True,
    ), fbs, 64)
