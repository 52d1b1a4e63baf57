"""The flagship frame (Renderer + HuffmanTpu.render) equals the plain
reference (render/reference.py: host-decoded points, the same
batch-relative projection, one global resolve), bit for bit, image and
depth plane."""

import numpy as np
import pytest

from pcrhpg24_tpu.engine.debug import Debug
from pcrhpg24_tpu.engine.method import Runtime
from pcrhpg24_tpu.engine.native_resource import NativeLasData
from pcrhpg24_tpu.engine.renderer import Renderer, Setting
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.formats.native_file import (
    decode_tpc_batch_coords, read_tpc_batch, read_tpc_header,
)
from pcrhpg24_tpu.preprocess import preprocess_las_tpc
from pcrhpg24_tpu.render.methods.huffman_tpu import HuffmanTpu
from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import HuffmanTpuHqs
from pcrhpg24_tpu.render.reference import chain_payload_bc1, reference_image
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud

W, H = 320, 180
BG = 0x00443322
VIEWS = {
    "orbit": Setting(yaw=0.5, pitch=-0.9, radius=900.0,
                     target=(300.0, 300.0, 100.0)),
    "closeup": Setting(yaw=2.4, pitch=-0.25, radius=90.0,
                       target=(300.0, 300.0, 60.0)),
    "oblique": Setting(yaw=-1.1, pitch=-0.08, radius=500.0,
                       target=(300.0, 300.0, 40.0)),
}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("flagship_ref")
    xyz, rgb = terrain_cloud(4 * 65536, seed=21, extent=600.0)
    grid = cloud_to_grid(xyz)
    las = str(d / "s.las")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    out = {}
    for version, codec in ((1, "huffman"), (2, "fixed")):
        tpc = str(d / f"s_v{version}.tpc")
        preprocess_las_tpc(las, tpc, sort=True, verbose=False, codec=codec)
        hdr = read_tpc_header(tpc)
        items = [read_tpc_batch(tpc, hdr, i) for i in range(hdr.num_batches)]
        coords = np.stack([decode_tpc_batch_coords(b) for b, _c in items])
        payload = np.stack([chain_payload_bc1(c) for _b, c in items])
        anchors = np.stack([np.asarray(b.start_values).reshape(-1, 3).min(0)
                            for b, _c in items])
        out[version] = (tpc, coords, payload, anchors)
    return out


def _render(tpc, view, lod, method_cls):
    Runtime.resource = None
    data = NativeLasData.create(tpc)
    r = Renderer(W, H)
    r.apply_setting(VIEWS[view])
    m = method_cls(r, data)
    m.update(r)
    data.wait_loaded(r)
    Debug.lod = lod
    try:
        img = np.asarray(r.loop(m.update, m.render, frames=1))
        fb_d = np.asarray(r.last_fb[0])
        _, lod_full = m.frame_setup(r)
    finally:
        Debug.lod = 0.1
    cam = r.camera
    ref_args = (lod_full[: data.num_batches], cam.proj() @ cam.view(),
                data.scale, data.offset, data.las_min)
    data.unload(r)
    return img, fb_d, ref_args


@pytest.mark.parametrize("lod", [1.0, 0.3])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("view", list(VIEWS))
def test_frame_matches_reference(scenes, view, version, lod):
    tpc, coords, payload, anchors = scenes[version]
    img, _fb_d, (lod_n, wvp, scale, offset, las_min) = _render(
        tpc, view, lod, HuffmanTpu)
    ref = reference_image(coords, payload, anchors, lod_n, wvp, scale,
                          offset, las_min, W, H)
    assert (ref != BG).sum() > 500  # the view sees the scene
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("view", ["orbit", "closeup"])
def test_hqs_frame_matches_reference(scenes, view):
    tpc, coords, payload, anchors = scenes[2]
    img, _fb_d, (lod_n, wvp, scale, offset, las_min) = _render(
        tpc, view, 1.0, HuffmanTpuHqs)
    ref = reference_image(coords, payload, anchors, lod_n, wvp, scale,
                          offset, las_min, W, H, hqs=True)
    assert (ref != BG).sum() > 500
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("method_cls", [HuffmanTpu, HuffmanTpuHqs])
@pytest.mark.parametrize("view", list(VIEWS))
def test_depth_plane_matches_reference(scenes, view, method_cls):
    """The frame's min-depth plane (renderer.last_fb[0], what
    save_depth_exr and EDL read) == the reference's, bit for bit."""
    tpc, coords, payload, anchors = scenes[2]
    _img, fb_d, (lod_n, wvp, scale, offset, las_min) = _render(
        tpc, view, 1.0, method_cls)
    _ref, ref_d = reference_image(coords, payload, anchors, lod_n, wvp,
                                  scale, offset, las_min, W, H, depth=True)
    assert (ref_d != 0xFFFFFFFF).sum() > 500
    np.testing.assert_array_equal(fb_d, ref_d)
