"""Batch-relative precision path (the reference's UseDouble equivalent).

render.cu:346-379 switches close-up batches to an f64 decode+project
path; absolute f32 coordinates of km-scale clouds lose millimetres.
The batch-relative path (camera.batch_translations + per-batch i32 anchors)
must pixel-match a full-f64 CPU rasterizer on a close-up view of a
large-extent cloud — a view where the old absolute-f32 path visibly
breaks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pcrhpg24_tpu.engine.debug import Debug
from pcrhpg24_tpu.engine.method import Runtime
from pcrhpg24_tpu.engine.native_resource import NativeLasData
from pcrhpg24_tpu.engine.renderer import Renderer, Setting
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.preprocess import preprocess_las_tpc

W, H = 320, 180


def _f64_reference_image(tpc, cam, W, H):
    """Trivially-correct CPU rasterizer: f64 end to end."""
    from pcrhpg24_tpu.codec.bc1 import decode_bc1
    from pcrhpg24_tpu.formats.native_file import (
        decode_tpc_batch_coords, read_tpc_batch, read_tpc_header,
    )

    hdr = read_tpc_header(tpc)
    wvp = (cam.proj() @ cam.view()).astype(np.float64)
    fb_key = np.full(W * H, np.iinfo(np.uint64).max, np.uint64)
    for b in range(hdr.num_batches):
        nb, colors = read_tpc_batch(tpc, hdr, b)
        coords = decode_tpc_batch_coords(nb).astype(np.float64)
        pos = coords * hdr.scale + hdr.offset - hdr.las_min
        clip = pos @ wvp[:3, :3].T + wvp[:3, 3]  # rows 0,1 and ...
        wrow = pos @ wvp[3, :3] + wvp[3, 3]
        ndc_x = clip[:, 0] / wrow
        ndc_y = clip[:, 1] / wrow
        ok = (wrow > 0) & (np.abs(ndc_x) <= 1) & (np.abs(ndc_y) <= 1)
        px = ((ndc_x * 0.5 + 0.5) * W).astype(np.int64)
        py = ((ndc_y * 0.5 + 0.5) * H).astype(np.int64)
        ok &= (px >= 0) & (px < W) & (py >= 0) & (py < H)
        pid = px + py * W
        depth = np.float32(wrow).view(np.uint32).astype(np.uint64)
        rgb = decode_bc1(np.asarray(colors), np.arange(65536))
        key = (depth << np.uint64(32)) | rgb.astype(np.uint64)
        for i in np.nonzero(ok)[0]:
            if key[i] < fb_key[pid[i]]:
                fb_key[pid[i]] = key[i]
    img = np.where(
        fb_key != np.iinfo(np.uint64).max,
        (fb_key & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        np.uint32(0x00443322),
    )
    return img.reshape(H, W)


BASE = 1_073_700_000  # ~2^30 grid units: f32 cast rounds to +-32 units


@pytest.fixture(scope="module")
def big_extent_tpc(tmp_path_factory):
    # a dense 2 m patch at millimetre grid, ~1e9 grid units from the
    # origin: casting absolute coords to f32 costs +-32 mm — several
    # pixels at close range (the regime render.cu's UseDouble covers)
    rng = np.random.default_rng(3)
    n = 65536
    x = BASE + rng.integers(0, 2000, n).astype(np.int64)
    y = BASE + rng.integers(0, 2000, n).astype(np.int64)
    z = rng.integers(0, 2000, n).astype(np.int64)
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    d = tmp_path_factory.mktemp("prec")
    las = str(d / "big.las")
    tpc = str(d / "big.tpc")
    write_las(las, x, y, z, rgb, scale=(0.001, 0.001, 0.001))
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    return tpc


def test_batch_relative_matches_f64_reference(big_extent_tpc):
    tpc = big_extent_tpc
    Runtime.resource = None
    Debug.lod = 1.0
    data = NativeLasData.create(tpc)
    r = Renderer(W, H)
    # close-up on the 2 m patch (render frame = world - las_min)
    r.apply_setting(Setting(yaw=0.3, pitch=-0.8, radius=3.0,
                            target=(1.0, 1.0, 1.0)))
    from pcrhpg24_tpu.render.methods.huffman_tpu import HuffmanTpu

    m = HuffmanTpu(r, data)
    m.update(r)
    data.wait_loaded(r)
    img = np.asarray(r.loop(m.update, m.render, frames=1))
    r.controls_update()
    ref = _f64_reference_image(tpc, r.camera, W, H)

    agree = (img == ref).mean()
    filled = (ref != 0x00443322).mean()
    assert filled > 0.05, "camera must actually see the cloud"
    assert agree > 0.995, f"batch-relative path vs f64 reference: {agree}"
    data.unload(r)


def test_absolute_f32_path_would_fail(big_extent_tpc):
    """Sanity: the pre-round-2 absolute-f32 projection visibly diverges
    on the same view (documents why the batch-relative path exists)."""
    from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native

    tpc = big_extent_tpc
    Runtime.resource = None
    Debug.lod = 1.0
    data = NativeLasData.create(tpc)
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.3, pitch=-0.8, radius=3.0,
                            target=(1.0, 1.0, 1.0)))
    from pcrhpg24_tpu.render.methods.huffman_tpu import HuffmanTpu

    m = HuffmanTpu(r, data)
    m.update(r)
    data.wait_loaded(r)
    r.controls_update()
    cam = r.camera
    fp = np.zeros(40, np.float32)
    fp[0:16] = cam.view().astype(np.float32).reshape(-1)
    fp[16:22] = cam.proj_params().astype(np.float32)
    fp[22] = 1.0
    fp[23] = float(data.num_batches_loaded)
    fp[24:40] = (cam.proj() @ cam.view()).astype(np.float32).reshape(-1)
    consts = (
        jnp.asarray(data.scale, jnp.float32),
        jnp.asarray(data.offset - data.las_min, jnp.float32),
    )
    kw = dict(width=W, height=H, mode="color", nchunks=1,
              cull=True, fmt="fixed")
    _d, _p, img_abs = render_frame_native(
        data.dev, jnp.asarray(fp), *consts, **kw)  # tb=None: absolute f32
    ref = _f64_reference_image(tpc, cam, W, H)
    agree_abs = (np.asarray(img_abs) == ref).mean()
    assert agree_abs < 0.99, (
        f"absolute-f32 unexpectedly exact ({agree_abs}); test scene too easy"
    )
    data.unload(r)
