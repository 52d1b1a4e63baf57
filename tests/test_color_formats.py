"""Color-format plumbing: raw / BC1 / BC7 end-to-end on the .tpc path.

Reference: compile-time COLOR_COMPRESSION 0|1|7
(modules/compute/Resources.h:15), GPU decoders render.cu:67-154 —
here a per-file container option (TPC3 header field).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pcrhpg24_tpu.codec.bc7 import decode_bc7, encode_bc7
from pcrhpg24_tpu.render.bc1_layout import (
    bc7_payload_native, raw_payload_native,
)

BG = 0x00443322


def _rand_colors(n, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, n).astype(np.uint32)
        | (rng.integers(0, 256, n).astype(np.uint32) << 8)
        | (rng.integers(0, 256, n).astype(np.uint32) << 16)
    )


def test_bc7_payload_layout_matches_cpu_mirror():
    """The XLA BC7 decode in the native kernel layout must equal the
    NumPy mirror decoder (which itself mirrors render.cu:122-154) at
    every (g, lane, i) position."""
    n = 65536
    colors = _rand_colors(n, seed=5)
    blocks = encode_bc7(colors)
    pay = np.asarray(bc7_payload_native(
        jnp.asarray(blocks[None, :]), None, points=64))  # (1, 64, 8, 128)
    # native layout local id = (g*128 + l)*64 + i
    g, l, i = np.meshgrid(np.arange(8), np.arange(128), np.arange(64),
                          indexing="ij")
    local = (g * 128 + l) * 64 + i
    want = decode_bc7(blocks, local.reshape(-1)).reshape(8, 128, 64)
    got = np.transpose(pay[0], (1, 2, 0))  # (8, 128, 64)
    np.testing.assert_array_equal(got, want)


def test_bc7_roundtrip_quality():
    """Mode-6 BC7 must beat BC1 on the same data (7+p-bit endpoints,
    16 weights vs 5-6-5 and 4)."""
    from pcrhpg24_tpu.codec.bc1 import decode_bc1, encode_bc1

    n = 4096
    colors = _rand_colors(n, seed=7)
    ids = np.arange(n)

    def err(dec):
        d = dec.astype(np.int64)
        c = colors.astype(np.int64)
        tot = 0
        for s in (0, 8, 16):
            tot += np.abs(((d >> s) & 255) - ((c >> s) & 255)).mean()
        return tot

    e7 = err(decode_bc7(encode_bc7(colors), ids))
    e1 = err(decode_bc1(encode_bc1(colors), ids))
    assert e7 < e1


def test_raw_payload_layout():
    n = 65536
    colors = _rand_colors(n, seed=9)
    pay = np.asarray(raw_payload_native(
        jnp.asarray(colors[None, :]), None, points=64))
    g, l, i = np.meshgrid(np.arange(8), np.arange(128), np.arange(64),
                          indexing="ij")
    local = (g * 128 + l) * 64 + i
    want = (colors & 0xFFFFFF)[local]
    np.testing.assert_array_equal(np.transpose(pay[0], (1, 2, 0)), want)


@pytest.fixture(scope="module")
def las_scene(tmp_path_factory):
    from pcrhpg24_tpu.formats.las import write_las
    from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud

    d = tmp_path_factory.mktemp("colorfmt")
    xyz, rgb = terrain_cloud(65536, seed=21, extent=600.0)
    grid = cloud_to_grid(xyz)
    las = str(d / "s.las")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    return las, str(d)


@pytest.mark.parametrize("fmt", ["raw", "bc1", "bc7"])
def test_tpc_color_fmt_end_to_end(las_scene, fmt):
    """preprocess --color -> TPC3 container -> resource -> flagship
    frame; raw winners must carry their EXACT original colors."""
    import jax

    from pcrhpg24_tpu.engine.native_resource import NativeLasData
    from pcrhpg24_tpu.formats.las import read_points
    from pcrhpg24_tpu.formats.native_file import read_tpc_header
    from pcrhpg24_tpu.preprocess import preprocess_las_tpc
    from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native

    las, d = las_scene
    tpc = f"{d}/s_{fmt}.tpc"
    preprocess_las_tpc(las, tpc, sort=True, verbose=False, color_fmt=fmt)
    hdr = read_tpc_header(tpc)
    assert hdr.color_fmt == fmt
    assert hdr.version == 2

    res = NativeLasData.create(tpc).wait_loaded()
    assert res.color_fmt == fmt
    from __graft_entry__ import _flagship_frame_args

    W, H = 320, 180
    fpd, scale, offset_rel, tb = _flagship_frame_args(res, W, H)
    _d, fb_p, img = render_frame_native(
        res.dev, fpd, scale, offset_rel, width=W, height=H, mode="color",
        nchunks=1, cull=True, points=64, fmt="fixed", tb=tb, color_fmt=fmt,
    )
    img = np.asarray(img)
    assert (img != BG).mean() > 0.02
    if fmt == "raw":
        pts = read_points(las, 0, 65536)
        allowed = set((pts.color & 0xFFFFFF).tolist())
        allowed.add(BG)
        got = set(np.unique(img).tolist())
        assert got <= allowed, f"{len(got - allowed)} foreign colors"


def test_bc7_bc1_similar_images(las_scene):
    """BC7 and BC1 are different lossy encodings of the same colors —
    winners are the same points, colors must agree closely."""
    from pcrhpg24_tpu.engine.native_resource import NativeLasData
    from pcrhpg24_tpu.preprocess import preprocess_las_tpc
    from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native
    from __graft_entry__ import _flagship_frame_args

    las, d = las_scene
    imgs = {}
    for fmt in ("bc1", "bc7"):
        tpc = f"{d}/s_{fmt}.tpc"
        import os
        if not os.path.exists(tpc):
            preprocess_las_tpc(las, tpc, sort=True, verbose=False,
                               color_fmt=fmt)
        res = NativeLasData.create(tpc).wait_loaded()
        W, H = 320, 180
        fpd, scale, offset_rel, tb = _flagship_frame_args(res, W, H)
        _dd, _p, img = render_frame_native(
            res.dev, fpd, scale, offset_rel, width=W, height=H,
            mode="color", nchunks=1, cull=True,
            points=64, fmt="fixed", tb=tb,
            color_fmt=fmt,
        )
        imgs[fmt] = np.asarray(img)
    both = (imgs["bc1"] != BG) & (imgs["bc7"] != BG)
    assert both.mean() > 0.02
    diff = 0.0
    for s in (0, 8, 16):
        a = ((imgs["bc1"] >> s) & 255).astype(np.int64)
        b = ((imgs["bc7"] >> s) & 255).astype(np.int64)
        diff += np.abs(a - b)[both].mean()
    assert diff < 30.0, f"mean |bc1-bc7| channel diff {diff}"