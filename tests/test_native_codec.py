"""Native (tbatch) codec round trips."""

import numpy as np
import pytest

from pcrhpg24_tpu.codec.morton import morton_order
from pcrhpg24_tpu.codec.native import (
    decode_native_batch,
    encode_native_batch,
    unzigzag,
    zigzag,
    _bitlen,
)


def test_zigzag_roundtrip():
    v = np.array([0, 1, -1, 2, -2, 2**31 - 1, -(2**31)], np.int64)
    np.testing.assert_array_equal(unzigzag(zigzag(v)), v)


def test_bitlen():
    z = np.array([0, 1, 2, 3, 4, 255, 256, 2**32 - 1], np.uint64)
    np.testing.assert_array_equal(_bitlen(z), [0, 1, 2, 2, 3, 8, 9, 32])


def _cloud(seed, jumpy=False):
    rng = np.random.default_rng(seed)
    n = 65536
    steps = rng.integers(-60, 60, size=(n, 3))
    if jumpy:
        steps += rng.integers(-(2**28), 2**28, size=(n, 3)) * (
            rng.random((n, 1)) < 0.01
        )
    pts = np.cumsum(steps, axis=0, dtype=np.int64)
    pts = ((pts + 2**31) % 2**32 - 2**31).astype(np.int32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    o = morton_order(x, y, z)
    return x[o], y[o], z[o]


@pytest.mark.parametrize("jumpy", [False, True])
def test_native_roundtrip(jumpy):
    x, y, z = _cloud(3, jumpy)
    nb = encode_native_batch(x, y, z)
    coords = decode_native_batch(nb)
    np.testing.assert_array_equal(coords, np.stack([x, y, z], 1))


def test_native_compression_beats_reference_format():
    from pcrhpg24_tpu.codec.batch_codec import encode_batch

    x, y, z = _cloud(7)
    nb = encode_native_batch(x, y, z)
    eb = encode_batch(x, y, z)
    native_bytes = 4 * nb.total_words + 12 * 1024 + 64
    ref_bytes = (
        4 * (len(eb.encoding) + len(eb.separate) + 2 * 4096 + 32) + 12 * 1024
    )
    assert native_bytes < ref_bytes
