"""Multi-chip sharded render == single-device render (8-dev CPU mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from __graft_entry__ import _tiny_scene
from pcrhpg24_tpu.parallel.mesh import (
    _local_raster,
    make_multichip_render,
    shard_streams_host,
)
from pcrhpg24_tpu.render.decode_jax import decode_batches_core


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_matches_single():
    dp, sp = 4, 2
    devices = np.asarray(jax.devices()[: dp * sp]).reshape(dp, sp)
    mesh = Mesh(devices, ("dp", "sp"))
    W, H = 128, 64 * sp
    scene = _tiny_scene(dp, seed=3)
    transform = jnp.asarray(np.eye(4), jnp.float32).at[3, :].set(
        jnp.asarray([0.0, 0.0, 1e-3, 1.0])
    )
    lod_n = jnp.full((dp,), 64, jnp.int32)
    scale = jnp.asarray([0.01, 0.01, 0.01], jnp.float32)
    offset_rel = jnp.asarray([0.0, 0.0, 0.0], jnp.float32)

    sharded = shard_streams_host({k: np.asarray(v) for k, v in scene.items()}, dp)
    # each shard holds only its own stream bytes (1 batch here)
    assert sharded["encoding"].shape[0] == dp
    assert sharded["encoding"].size < np.asarray(scene["encoding"]).size * dp
    args_sh = (
        jnp.asarray(sharded["encoding"]), jnp.asarray(sharded["enc_offsets"]),
        scene["cluster_sizes"],
        jnp.asarray(sharded["separate"]), jnp.asarray(sharded["sep_offsets"]),
        scene["separate_sizes"], scene["table_values"], scene["table_cw_len"],
        scene["start_values"], lod_n, transform, scale, offset_rel,
    )

    img_sharded = np.asarray(jax.jit(make_multichip_render(mesh, W, H))(*args_sh))

    # single-device reference (flat streams, global payload ids)
    coords = decode_batches_core(
        scene["encoding"], scene["enc_offsets"], scene["cluster_sizes"],
        scene["separate"], scene["sep_offsets"], scene["separate_sizes"],
        scene["table_values"], scene["table_cw_len"], scene["start_values"],
    )
    fb_d, fb_p = _local_raster(coords, scale, offset_rel, lod_n, transform, W, H)
    img_single = np.asarray(
        jnp.where(fb_p != jnp.uint32(0xFFFFFFFF), fb_p, jnp.uint32(0x00443322))
    ).reshape(H, W)

    # payloads are rebased to global chunk ids, so the sharded winner is
    # exactly the single-device winner (u64-min semantics are exact)
    mismatch = np.argwhere(img_sharded != img_single)
    assert mismatch.size == 0, f"{mismatch.shape[0]} mismatching pixels"
    assert (img_sharded != 0x00443322).sum() >= 10  # tiny synthetic scene


# ---------------- flagship fbatch pipeline, sharded ----------------


@pytest.fixture(scope="module")
def tpc_scene(tmp_path_factory):
    from pcrhpg24_tpu.engine.native_resource import NativeLasData
    from pcrhpg24_tpu.formats.las import write_las
    from pcrhpg24_tpu.preprocess import preprocess_las_tpc
    from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud

    d = tmp_path_factory.mktemp("mesh_tpc")
    xyz, rgb = terrain_cloud(3 * 65536, seed=13, extent=900.0)
    grid = cloud_to_grid(xyz)
    las = str(d / "s.las")
    tpc = str(d / "s.tpc")
    write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    preprocess_las_tpc(las, tpc, sort=True, verbose=False)
    return NativeLasData.create(tpc).wait_loaded()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("kind", ["color", "hqs"])
def test_flagship_sharded_matches_single(tpc_scene, kind):
    """dp-sharded fbatch flagship frame (and HQS) == single-device,
    bit-exact: u64-min winners / sums are associative over any batch
    partition, and BC1 payloads are shard-invariant."""
    _sharded_vs_single(tpc_scene, kind, 4, 2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("kind", ["color", "hqs"])
def test_flagship_sharded_2x2_matches_single(tpc_scene, kind):
    """The same on a 2x2 mesh: two batches per dp shard."""
    _sharded_vs_single(tpc_scene, kind, 2, 2)


def _sharded_vs_single(tpc_scene, kind, dp, sp):
    from __graft_entry__ import _flagship_frame_args
    from pcrhpg24_tpu.parallel.mesh_native import (
        _DEV_SPEC_KEYS, make_flagship_hqs, make_flagship_render,
    )
    from pcrhpg24_tpu.render.methods.huffman_tpu import render_frame_native
    from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import hqs_frame_native

    las = tpc_scene
    devices = np.asarray(jax.devices()[: dp * sp]).reshape(dp, sp)
    mesh = Mesh(devices, ("dp", "sp"))
    W, H = 256, 144
    fpd, scale, offset_rel, tb = _flagship_frame_args(las, W, H)
    dev = {k: las.dev[k][:4] for k in _DEV_SPEC_KEYS}  # 3 real + 1 pad
    tbs = tb[:4]

    if kind == "color":
        img_sh = np.asarray(jax.jit(make_flagship_render(mesh, W, H))(
            dev, fpd, scale, offset_rel, tbs))
        _d, _p, img_1 = render_frame_native(
            las.dev, fpd, scale, offset_rel, width=W, height=H,
            mode="color", nchunks=1, cull=True, points=64,
            fmt="fixed", tb=tb,
        )
    else:
        img_sh = np.asarray(jax.jit(make_flagship_hqs(mesh, W, H))(
            dev, fpd, scale, offset_rel, tbs))
        _fbd, _accn, img_1 = hqs_frame_native(
            las.dev, fpd, scale, offset_rel, W, H, 1, True, "fixed", tb, 64,
        )
    img_1 = np.asarray(img_1)
    mismatch = np.argwhere(img_sh != img_1)
    assert mismatch.size == 0, f"{mismatch.shape[0]} mismatching pixels"
    assert (img_sh != 0x00443322).sum() >= 100
