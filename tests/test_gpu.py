"""Checks that need an NVIDIA GPU (marker `gpu`; they skip elsewhere).

Run on the card:  JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist
chip_smoke.py runs the same checks at full size.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_decode_kernel_compiled_matches_mirror(gpu_device):
    import jax

    from pcrhpg24_tpu.codec.fixed import (
        decode_fixed_batch, encode_fixed_batch, pack_fixed_batches,
    )
    from pcrhpg24_tpu.render.decode_fixed_triton import decode_fixed_triton

    rng = np.random.default_rng(0)
    fbs = []
    for s in range(4):
        base = np.cumsum(rng.integers(-30, 31, (65536, 3)), axis=0)
        fbs.append(encode_fixed_batch(*(base[:, i].astype(np.int32)
                                        for i in range(3))))
    pk = {k: jax.device_put(v, gpu_device)
          for k, v in pack_fixed_batches(fbs).items()}
    out = np.asarray(decode_fixed_triton(pk["widths"], pk["streams"],
                                         pk["ptrs"], pk["starts"]))
    for b, fb in enumerate(fbs):
        ref = decode_fixed_batch(fb).reshape(8, 128, 64, 3)
        np.testing.assert_array_equal(np.transpose(out[b], (2, 3, 0, 1)), ref)


def test_frame_on_card_matches_reference(gpu_device):
    """The flagship frame on the card == the plain reference run on the
    same card, bit for bit."""
    from __graft_entry__ import _flagship_frame_args, _tiny_tpc
    from pcrhpg24_tpu.formats.native_file import (
        decode_tpc_batch_coords, read_tpc_batch,
    )
    from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native
    from pcrhpg24_tpu.render.reference import (
        chain_payload_bc1, reference_image,
    )

    las = _tiny_tpc(2)
    W, H = 640, 360
    fpd, scale, offset_rel, tb = _flagship_frame_args(las, W, H)
    _d, _p, img = render_frame_native(
        las.dev, fpd, scale, offset_rel, width=W, height=H, mode="color",
        nchunks=1, cull=True, points=64, fmt="fixed",
        tb=tb)
    items = [read_tpc_batch(las.path, las.header, i) for i in range(2)]
    wvp = np.asarray(fpd[24:40], np.float64).reshape(4, 4)
    ref = reference_image(
        np.stack([decode_tpc_batch_coords(b) for b, _c in items]),
        np.stack([chain_payload_bc1(c) for _b, c in items]),
        las.anchor_i[:2], np.full(2, 64), wvp, las.scale, las.offset,
        las.las_min, W, H, device=gpu_device)
    np.testing.assert_array_equal(np.asarray(img), ref)
