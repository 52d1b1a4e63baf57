"""LAZ (LASzip v2) codec: round-trips and pipeline integration."""

import numpy as np
import pytest

from pcrhpg24_tpu.formats.las import read_header, read_points
from pcrhpg24_tpu.formats.laz import (
    CHUNK_SIZE,
    Decoder,
    Encoder,
    IntegerCompressor,
    read_laz_points,
    write_laz,
)


def test_arithmetic_coder_roundtrip():
    rng = np.random.default_rng(0)
    from pcrhpg24_tpu.formats.laz import BitModel, SymbolModel

    bits = rng.integers(0, 2, 500).tolist()
    syms = rng.integers(0, 33, 500).tolist()
    raw = rng.integers(0, 2**19, 100).tolist()
    enc = Encoder()
    bm = BitModel()
    sm = SymbolModel(33, True)
    for b in bits:
        enc.encode_bit(bm, b)
    for s in syms:
        enc.encode_symbol(sm, s)
    for v in raw:
        enc.write_bits(19, v)
    data = enc.done()

    dec = Decoder(data)
    bm2 = BitModel()
    sm2 = SymbolModel(33, False)
    assert [dec.decode_bit(bm2) for _ in bits] == bits
    assert [dec.decode_symbol(sm2) for _ in syms] == syms
    assert [dec.read_bits(19) for _ in raw] == raw


def test_integer_compressor_roundtrip():
    rng = np.random.default_rng(1)
    vals = np.concatenate([
        rng.integers(-5, 6, 300),
        rng.integers(-(2**30), 2**30, 50),
        [0, 1, -1, 2**31 - 1, -(2**31)],
    ]).astype(np.int64)
    preds = np.roll(vals, 1)
    preds[0] = 0
    enc = Encoder()
    ic = IntegerCompressor(enc, 32, 3, compress=True)
    for p, v in zip(preds, vals):
        ic.compress(int(p), int(np.int32(v)), 1)
    data = enc.done()
    dec = Decoder(data)
    icd = IntegerCompressor(dec, 32, 3, compress=False)
    got = [icd.decompress(int(p), 1) for p in preds]
    np.testing.assert_array_equal(got, vals.astype(np.int32))


@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
def test_laz_file_roundtrip(tmp_path, fmt):
    rng = np.random.default_rng(fmt)
    n = 3000
    base = np.cumsum(rng.integers(-50, 51, (n, 3)), axis=0)
    x, y, z = (base[:, i].astype(np.int32) for i in range(3))
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    gps = np.cumsum(rng.random(n) * 1e-4) + 300000.0
    path = str(tmp_path / f"t{fmt}.laz")
    write_laz(path, x, y, z, rgb=rgb if fmt in (2, 3) else None,
              gps_time=gps if fmt in (1, 3) else None,
              point_format=fmt, chunk_size=1000)  # multiple chunks

    h = read_header(path)
    assert h.compressed
    assert h.point_format == fmt
    assert h.num_points == n

    pts = read_points(path)  # transparent dispatch through las.py
    np.testing.assert_array_equal(pts.x, x)
    np.testing.assert_array_equal(pts.y, y)
    np.testing.assert_array_equal(pts.z, z)
    if fmt in (2, 3):
        col = (rgb[:, 0].astype(np.uint32) | (rgb[:, 1].astype(np.uint32) << 8)
               | (rgb[:, 2].astype(np.uint32) << 16))
        np.testing.assert_array_equal(pts.color, col)


def test_laz_partial_reads(tmp_path):
    rng = np.random.default_rng(9)
    n = 2500
    base = np.cumsum(rng.integers(-10, 11, (n, 3)), axis=0)
    x, y, z = (base[:, i].astype(np.int32) for i in range(3))
    path = str(tmp_path / "p.laz")
    write_laz(path, x, y, z, point_format=0, chunk_size=1000)
    pts = read_laz_points(path, first=1500, count=600)
    np.testing.assert_array_equal(pts.x, x[1500:2100])
    np.testing.assert_array_equal(pts.z, z[1500:2100])


def test_preprocess_from_laz(tmp_path):
    """End-to-end: .laz -> preprocess -> .tpc renders through the app
    pipeline (compressed-LAS ingestion)."""
    from pcrhpg24_tpu.preprocess import preprocess_las_tpc
    from pcrhpg24_tpu.formats.native_file import read_tpc_header

    rng = np.random.default_rng(4)
    n = 70_000
    base = np.cumsum(rng.integers(-20, 21, (n, 3)), axis=0) + 100000
    x, y, z = (base[:, i].astype(np.int32) for i in range(3))
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    laz = str(tmp_path / "s.laz")
    tpc = str(tmp_path / "s.tpc")
    write_laz(laz, x, y, z, rgb=rgb, point_format=2)
    preprocess_las_tpc(laz, tpc, sort=True, verbose=False)
    hdr = read_tpc_header(tpc)
    assert hdr.num_batches == 2
    assert hdr.num_points == 2 * 65536


def test_multifile_sparse_resource(tmp_path):
    """LasSparseData concatenates multiple LAS/LAZ files and renders
    through the app pipeline (LasLoaderSparse equivalent)."""
    from pcrhpg24_tpu.formats.las import write_las
    from pcrhpg24_tpu.engine.las_sparse import LasSparseData
    from pcrhpg24_tpu.engine.renderer import Renderer, Setting
    from pcrhpg24_tpu.render.methods.basic import BasicMethod
    from pcrhpg24_tpu.engine.method import Runtime

    rng = np.random.default_rng(6)
    paths = []
    total = 0
    allxyz = []
    for i, n in enumerate((40_000, 30_000, 20_000)):
        base = np.cumsum(rng.integers(-20, 21, (n, 3)), axis=0) + i * 50_000
        x, y, z = (base[:, k].astype(np.int32) for k in range(3))
        rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
        p = str(tmp_path / f"f{i}.{'laz' if i == 1 else 'las'}")
        if i == 1:
            write_laz(p, x, y, z, rgb=rgb, point_format=2)
        else:
            write_las(p, x, y, z, rgb)
        paths.append(p)
        allxyz.append(base)
        total += n

    data = LasSparseData.create(",".join(paths))
    assert data.num_points == total
    data.wait_loaded()
    assert data.num_points_loaded >= total  # padded to batch multiple
    # spot-check concatenation order: first point of file 1 lands after
    # file 0's points
    x_dev = np.asarray(data.dev["x"])[: total]
    np.testing.assert_array_equal(x_dev[:40_000], allxyz[0][:, 0])

    # and it renders through a real method
    Runtime.resource = None
    r = Renderer(160, 90)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.7, radius=3000.0,
                            target=(30.0, 30.0, 0.0)))
    m = BasicMethod(r, data)
    m.update(r)
    img = np.asarray(r.loop(m.update, m.render, frames=1))
    assert (img != 0x00443322).any()
    data.unload()


def test_app_glob_scene(tmp_path):
    """app.py --scene 'dir/*.las' builds the sparse multi-file methods."""
    from pcrhpg24_tpu import app as app_mod
    from pcrhpg24_tpu.engine.renderer import Renderer
    from pcrhpg24_tpu.formats.las import write_las

    rng = np.random.default_rng(8)
    for i in range(2):
        base = np.cumsum(rng.integers(-10, 11, (30_000, 3)), axis=0)
        write_las(str(tmp_path / f"g{i}.las"),
                  base[:, 0].astype(np.int32), base[:, 1].astype(np.int32),
                  base[:, 2].astype(np.int32),
                  rng.integers(0, 255, (30_000, 3)).astype(np.uint8))
    r = Renderer(160, 90)
    methods = app_mod.build_methods(r, str(tmp_path / "g*.las"))
    assert any(m.name == "basic_cuda" for m in methods) or len(methods) >= 1
