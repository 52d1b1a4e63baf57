"""Device cull + LOD (camera.frame_setup_device, f32 with full-precision
products) against the host f64 frame setup over a grid of views.

The two may disagree only where the f64 value sits on a boundary that
f32 cannot resolve: a LOD count whose f64 `percentage * 64` lies within
1e-4 of an integer, or a box whose nearest frustum plane distance is
within 1e-4 of its size.  Everywhere else they agree exactly.
"""

import numpy as np
import pytest

from pcrhpg24_tpu.render.camera import (
    Camera, OrbitControls, batches_in_frustum, frame_setup_device,
    frustum_planes, lod_points_per_thread,
)

W, H = 640, 360


def _boxes(seed=0, n=2000, extent=2000.0):
    rng = np.random.default_rng(seed)
    lo = rng.random((n, 3)) * [extent, extent, 200.0]
    size = rng.random((n, 3)) * [60.0, 60.0, 20.0] + 0.5
    return lo.astype(np.float32), (lo + size).astype(np.float32)


def _camera(yaw, pitch, radius):
    cam = Camera(width=W, height=H)
    cam.world = OrbitControls(yaw=yaw, pitch=pitch, radius=radius,
                              target=np.array([1000.0, 1000.0, 80.0])).world()
    return cam


def _host(cam, bmin, bmax, lod):
    view, proj = cam.view(), cam.proj()
    n, _ = lod_points_per_thread(view, proj, bmin.astype(np.float64),
                                 bmax.astype(np.float64), W, H, 64, lod)
    vis = batches_in_frustum(frustum_planes(proj @ view), bmin, bmax)
    return np.where(vis, n, 0)


def _device(cam, bmin, bmax, lod):
    import jax.numpy as jnp

    return np.asarray(frame_setup_device(
        jnp.asarray(cam.view().astype(np.float32)),
        jnp.asarray(cam.proj_params().astype(np.float32)),
        jnp.asarray(bmin), jnp.asarray(bmax), len(bmin), W, H,
        np.float32(lod), True))


@pytest.mark.parametrize("lod", [1.0, 0.1])
@pytest.mark.parametrize("radius", [150.0, 900.0, 4000.0])
def test_device_lod_and_cull_match_host(radius, lod):
    bmin, bmax = _boxes()
    mism = 0
    for yaw in np.linspace(-3.0, 3.0, 5):
        for pitch in (-1.2, -0.6, -0.1):
            cam = _camera(yaw, pitch, radius)
            host = _host(cam, bmin, bmax, lod)
            dev = _device(cam, bmin, bmax, lod)
            bad = np.flatnonzero(host != dev)
            mism += len(bad)
            for b in bad:
                # only boundary cases may differ, by at most one point or
                # a marginal cull
                assert abs(int(host[b]) - int(dev[b])) <= 1 or \
                    min(host[b], dev[b]) == 0, (yaw, pitch, b)
    # boundary cases are rare
    assert mism <= 0.001 * 15 * len(bmin), mism
