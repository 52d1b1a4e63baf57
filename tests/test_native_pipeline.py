"""Native .tpc pipeline: preprocess -> file -> loader -> method == flagship."""

import numpy as np
import jax.numpy as jnp
import pytest

from pcrhpg24_tpu.engine.debug import Debug
from pcrhpg24_tpu.engine.native_resource import NativeLasData
from pcrhpg24_tpu.engine.renderer import Renderer, Setting
from pcrhpg24_tpu.engine.resource import HuffmanLasData
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.formats.native_file import (
    decode_tpc_batch_coords,
    read_tpc_batch,
    read_tpc_header,
    transcode_huffman_to_tpc,
)
from pcrhpg24_tpu.preprocess import preprocess_las, preprocess_las_tpc
from pcrhpg24_tpu.render.methods.huffman_mem_iter import HuffmanMemIter
from pcrhpg24_tpu.render.methods.huffman_tpu import HuffmanTpu
from pcrhpg24_tpu.render.raster import EMPTY
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud

W, H = 256, 144


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    xyz, rgb = terrain_cloud(150_000, seed=21, extent=900.0)
    grid = cloud_to_grid(xyz)
    d = tmp_path_factory.mktemp("tpc")
    las = str(d / "s.las")
    huf = str(d / "s.huffman")
    tpc = str(d / "s.tpc")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las(las, huf, sort=True, verbose=False)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    return las, huf, tpc


def test_tpc_file_roundtrip(paths):
    _las, _huf, tpc = paths
    hdr = read_tpc_header(tpc)
    assert hdr.num_batches == 3
    assert hdr.version == 2  # flagship format is v2 fixed-width
    nb, color = read_tpc_batch(tpc, hdr, 1)
    coords = decode_tpc_batch_coords(nb)  # must decode without error
    assert coords.shape == (65536, 3)
    assert len(color) == 65536 // 8


def test_transcode_matches_direct(paths):
    las, huf, tpc = paths
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        tpc2 = os.path.join(d, "t.tpc")
        transcode_huffman_to_tpc(huf, tpc2, verbose=False)
        h1 = read_tpc_header(tpc)
        h2 = read_tpc_header(tpc2)
        assert h1.num_batches == h2.num_batches
        for i in range(h1.num_batches):
            a, ca = read_tpc_batch(tpc, h1, i)
            b, cb = read_tpc_batch(tpc2, h2, i)
            np.testing.assert_array_equal(
                decode_tpc_batch_coords(a), decode_tpc_batch_coords(b)
            )
            np.testing.assert_array_equal(ca, cb)


def _run_method(method_cls, data_cls, path):
    from pcrhpg24_tpu.engine.method import Runtime

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(
        Setting(yaw=0.7, pitch=-0.7, radius=800.0, target=(450, 450, 100))
    )
    data = data_cls.create(path)
    m = method_cls(r, data)
    m.update(r)
    data.wait_loaded(r)
    img = np.asarray(r.loop(m.update, m.render, frames=1))
    fb = tuple(np.asarray(a) for a in r.last_fb)
    data.unload(r)
    return img, fb


def test_native_method_matches_reference_method(paths):
    """huffman_tpu must produce the same framebuffer as huffman_mem_iter."""
    _las, huf, tpc = paths
    Debug.lod = 1.0

    img_ref, fb_ref = _run_method(HuffmanMemIter, HuffmanLasData, huf)
    img_native, fb_native = _run_method(HuffmanTpu, NativeLasData, tpc)

    from tests.fbcompare import assert_fb_close

    assert_fb_close(fb_native[0], fb_native[1], fb_ref[0], fb_ref[1])
    assert (img_native == img_ref).mean() > 0.995


def test_native_hqs_matches_reference_hqs(paths):
    """huffman_tpu_hqs image ~= huffman_hqs image on the same scene."""
    from pcrhpg24_tpu.render.methods.huffman_hqs import HuffmanHQS
    from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import HuffmanTpuHqs

    _las, huf, tpc = paths
    Debug.lod = 1.0
    img_ref, _ = _run_method(HuffmanHQS, HuffmanLasData, huf)
    img_native, _ = _run_method(HuffmanTpuHqs, NativeLasData, tpc)
    agree = (img_ref == img_native).mean()
    assert agree > 0.99, f"HQS native vs reference agreement {agree}"


def test_lod_bucketed_decode_matches_full(paths):
    """Zoomed out, bucketed decode must render the same image as a full
    64-point decode (the extra points are LOD-masked either way)."""
    import jax.numpy as jnp

    from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native

    _las, _huf, tpc = paths
    Debug.lod = 0.1
    data = NativeLasData.create(tpc)
    r = Renderer(W, H)
    r.apply_setting(
        Setting(yaw=0.7, pitch=-0.7, radius=9000.0, target=(450, 450, 100))
    )
    m = HuffmanTpu(r, data)
    m.update(r)
    data.wait_loaded(r)
    r.controls_update()
    _wvp, lod_full = m.frame_setup(r)
    max_lod = int(lod_full.max())
    assert 0 < max_lod < 64, f"scene should be LOD-reduced (max {max_lod})"

    cam = r.camera
    fp = np.zeros(40, np.float32)
    fp[0:16] = cam.view().astype(np.float32).reshape(-1)
    fp[16:22] = cam.proj_params().astype(np.float32)
    fp[22] = Debug.lod
    fp[23] = float(data.num_batches_loaded)
    fp[24:40] = (cam.proj() @ cam.view()).astype(np.float32).reshape(-1)
    consts = (
        jnp.asarray(data.scale, jnp.float32),
        jnp.asarray(data.offset - data.las_min, jnp.float32),
    )
    kw = dict(width=W, height=H, mode="color", nchunks=1,
              cull=True, fmt="fixed" if data.version == 2 else "tbatch")
    bucket = max(16, -(-max_lod // 16) * 16)
    _d1, p1, img1 = render_frame_native(data.dev, jnp.asarray(fp), *consts,
                                        points=bucket, **kw)
    _d2, p2, img2 = render_frame_native(data.dev, jnp.asarray(fp), *consts,
                                        points=64, **kw)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    data.unload(r)
    Debug.lod = 0.1


def test_capture_depth_gate(paths, tmp_path):
    """A color frame always keeps its depth plane: save_depth_exr dumps
    it, and every lit pixel has a depth."""
    _las, _huf, tpc = paths
    Debug.lod = 1.0
    from pcrhpg24_tpu.engine.method import Runtime

    Runtime.resource = None
    data = NativeLasData.create(tpc)
    r = Renderer(W, H)
    r.apply_setting(
        Setting(yaw=0.7, pitch=-0.7, radius=800.0, target=(450, 450, 100))
    )
    m = HuffmanTpu(r, data)
    m.update(r)
    data.wait_loaded(r)

    img = np.asarray(r.loop(m.update, m.render, frames=1))
    fb_d, fb_p = (np.asarray(a) for a in r.last_fb)
    empty = int(EMPTY)
    lit = fb_p != empty
    assert lit.sum() > 1000
    assert (fb_d[lit] != empty).all() and (fb_d[~lit] == empty).all()
    assert (img.reshape(-1)[lit] == fb_p[lit]).all()
    r.save_depth_exr(str(tmp_path / "d.npy"))
    d = np.load(str(tmp_path / "d.npy"))[::-1].reshape(-1)
    np.testing.assert_array_equal(d[lit], fb_d[lit].view(np.float32))
    data.unload(r)


def test_colorize_overdraw_heatmap(paths):
    """Debug.colorize_overdraw renders the 5-bucket spectral heatmap
    (reference: compute_loop_las_hqs/resolve.cs:54-103)."""
    _las, _huf, tpc = paths
    from pcrhpg24_tpu.engine.method import Runtime

    Runtime.resource = None
    Debug.lod = 1.0
    Debug.colorize_overdraw = True
    try:
        data = NativeLasData.create(tpc)
        r = Renderer(W, H)
        r.apply_setting(
            Setting(yaw=0.7, pitch=-0.7, radius=800.0, target=(450, 450, 100))
        )
        m = HuffmanTpu(r, data)
        m.update(r)
        data.wait_loaded(r)
        img = np.asarray(r.loop(m.update, m.render, frames=1))
        spectral = {0x00BA832B, 0x00A4DDAB, 0x00BFFFFF, 0x0061AEFD,
                    0x001C19D7, 0x00443322}
        vals = set(np.unique(img).tolist())
        assert vals <= spectral, f"unexpected heatmap colors {vals - spectral}"
        assert len(vals & (spectral - {0x00443322})) >= 1  # some coverage
        counts = np.asarray(r.last_fb[1])
        assert counts.sum() > 0
        data.unload(r)
    finally:
        Debug.colorize_overdraw = False


def test_huffman_loadtime_fast_path(paths):
    """HuffmanNativeData (load-time fused C++ transcode, no .tpc on
    disk) must render the exact flagship framebuffer of the
    disk-transcoded .tpc scene, and match the XLA .huffman method."""
    from pcrhpg24_tpu.engine.native_resource import HuffmanNativeData

    _las, huf, tpc = paths
    Debug.lod = 1.0
    img_tpc, fb_tpc = _run_method(HuffmanTpu, NativeLasData, tpc)
    img_ld, fb_ld = _run_method(HuffmanTpu, HuffmanNativeData, huf)
    np.testing.assert_array_equal(np.asarray(img_ld), np.asarray(img_tpc))
    np.testing.assert_array_equal(np.asarray(fb_ld[1]), np.asarray(fb_tpc[1]))

    img_ref, fb_ref = _run_method(HuffmanMemIter, HuffmanLasData, huf)
    from tests.fbcompare import assert_fb_close

    assert_fb_close(fb_ld[0], fb_ld[1], fb_ref[0], fb_ref[1])
