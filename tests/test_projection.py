"""The flagship's per-chunk projection stage (render_chunk_native).

* exact-arithmetic frame: a power-of-two transform makes every f32 op
  exact, so pids and depths must equal a NumPy model bit for bit;
* LOD: the 16-point decode bucket with per-batch lod_n masking gives
  exactly the first points of the full decode;
* run collapse retires same-pixel points but keeps every pixel's exact
  u64 (depth<<32|payload) winner.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.codec.fixed import pack_fixed_batches
from pcrhpg24_tpu.formats.las import write_las
from pcrhpg24_tpu.formats.native_file import (
    decode_tpc_batch_coords, read_tpc_batch, read_tpc_header,
)
from pcrhpg24_tpu.preprocess import preprocess_las_tpc
from pcrhpg24_tpu.render.methods.huffman_tpu import render_chunk_native
from pcrhpg24_tpu.render.raster import swizzle_dims, swizzle_pid
from pcrhpg24_tpu.render.reference import chain_payload_bc1
from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud

W, H = 320, 180
SWZ = swizzle_dims(W, H)[2]  # the stream's "dropped" id


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    xyz, rgb = terrain_cloud(130_000, seed=11, extent=600.0)
    grid = cloud_to_grid(xyz)
    d = tmp_path_factory.mktemp("proj")
    las, tpc = str(d / "s.las"), str(d / "s.tpc")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    hdr = read_tpc_header(tpc)
    items = [read_tpc_batch(tpc, hdr, i) for i in range(hdr.num_batches)]
    nbs = [nb for nb, _c in items]
    dev = {k: jnp.asarray(v) for k, v in pack_fixed_batches(nbs).items()}
    colors = np.stack([c for _nb, c in items]).astype(np.uint32)
    dev["colors"] = jnp.asarray(colors)
    anchors = np.stack([np.asarray(nb.start_values).reshape(-1, 3).min(0)
                        for nb in nbs]).astype(np.int32)
    dev["anchor"] = jnp.asarray(anchors)
    coords = np.stack([decode_tpc_batch_coords(nb) for nb in nbs])
    payload = np.stack([chain_payload_bc1(c) for c in colors])
    return dev, anchors, coords, payload, hdr.num_batches


def _exact_frame(B):
    """cx = xs * 2^-19, w = 2 + zs * 2^-19: exact for |coords| < 2^20."""
    t = np.zeros((4, 4), np.float32)
    t[0, 0] = t[1, 1] = t[3, 2] = 2.0 ** -19
    tb = np.zeros((B, 4), np.float32)
    tb[:, 3] = 2.0
    return jnp.asarray(t), jnp.asarray(tb)


def _stream(dev, B, lod_n, points, mode):
    t, tb = _exact_frame(B)
    out = render_chunk_native(
        dev, 0, t, jnp.asarray(lod_n, jnp.int32), jnp.ones((3,), jnp.float32),
        jnp.zeros((3,), jnp.float32), W, H, mode, points=points,
        fmt="fixed", tb=tb, nbatches=B)
    # stream order (B, points, 8, 128) -> chain layout (B, 1024, points)
    return [np.asarray(a).astype(np.uint32).reshape(B, points, 1024)
            .transpose(0, 2, 1) for a in out]


def _winners(pid, dep, pay):
    live = pid < SWZ
    key = (dep.astype(np.uint64) << np.uint64(32)) | pay.astype(np.uint64)
    out = np.full(SWZ, np.uint64(0xFFFFFFFFFFFFFFFF))
    np.minimum.at(out, pid[live].astype(np.int64), key[live])
    return out


def test_projection_exact_arithmetic(scene):
    """pids, depths and BC1 payloads == a NumPy model of the frame."""
    dev, anchors, coords, payload, B = scene
    pid, dep, pay = _stream(dev, B, np.full(B, 64), 64, "hqs")
    rel = (coords - anchors[:, None, :]).astype(np.float32)
    x, y = rel[..., 0] * np.float32(2.0 ** -19), rel[..., 1] * np.float32(2.0 ** -19)
    w = np.float32(2.0) + rel[..., 2] * np.float32(2.0 ** -19)
    ndc_x, ndc_y = x * (np.float32(1) / w), y * (np.float32(1) / w)
    ok = (w > 0) & (np.abs(ndc_x) <= 1) & (np.abs(ndc_y) <= 1)
    px = ((ndc_x * np.float32(0.5) + np.float32(0.5)) * W).astype(np.int32)
    py = ((ndc_y * np.float32(0.5) + np.float32(0.5)) * H).astype(np.int32)
    ok &= (px >= 0) & (px < W) & (py >= 0) & (py < H)
    want = np.where(ok, swizzle_pid(px, py, W), SWZ).reshape(B, 1024, 64)
    np.testing.assert_array_equal(pid, want)
    np.testing.assert_array_equal(dep, w.view(np.uint32).reshape(B, 1024, 64))
    np.testing.assert_array_equal(pay, payload.reshape(B, 1024, 64))
    assert (pid < SWZ).sum() > 10_000


def test_projection_lod_bucket_exact(scene):
    """points=16 + per-batch lod_n == the first points of the full
    decode, with chain points past lod_n dropped."""
    dev, _a, _c, _p, B = scene
    lod_n = np.minimum(np.arange(B) * 7 + 3, 16)
    pid16, dep16, _y = _stream(dev, B, lod_n, 16, "hqs")
    pid64, dep64, _y = _stream(dev, B, np.full(B, 64), 64, "hqs")
    keep = np.broadcast_to(
        np.arange(16)[None, None, :] < lod_n[:, None, None], pid16.shape)
    np.testing.assert_array_equal(
        pid16, np.where(keep, pid64[..., :16], SWZ))
    np.testing.assert_array_equal(dep16[keep], dep64[..., :16][keep])


def test_chain_collapse_preserves_winners(scene):
    """Color mode collapses same-pixel runs within chains; the retired
    points never change a pixel's exact u64 winner."""
    dev, _a, _c, _p, B = scene
    lod_n = np.full(B, 64)
    cpid, cdep, cpay = _stream(dev, B, lod_n, 64, "color")
    hpid, hdep, hpay = _stream(dev, B, lod_n, 64, "hqs")
    assert (cpid < SWZ).sum() < (hpid < SWZ).sum()  # runs did collapse
    np.testing.assert_array_equal(_winners(cpid, cdep, cpay),
                                  _winners(hpid, hdep, hpay))
