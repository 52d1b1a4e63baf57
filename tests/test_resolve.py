"""The frame's resolve stages against NumPy models, on adversarial inputs.

* raster.merge_u64_min (the running-framebuffer u64 min the flagship,
  the sharded frames and the Potree frames merge every chunk with)
  against np.minimum.at on (depth<<32)|payload keys;
* raster.hqs_accumulate (the tolerance-gated HQS sums) against
  np.add.at;
* the plain reference's independent resolve against both models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pcrhpg24_tpu.render.raster import (
    EMPTY, hqs_accumulate, merge_u64_min, scatter_u64_min,
)

SIZE = 4096
ALL = 0xFFFFFFFFFFFFFFFF
BG = 0x00443322


def _keys(depth, payload):
    return (depth.astype(np.uint64) << np.uint64(32)) | payload.astype(np.uint64)


def _np_min(pid, depth, payload, size=SIZE, fb=None):
    """u64-min model; pids outside [0, size) are dropped."""
    out = np.full(size, ALL, np.uint64) if fb is None else fb.copy()
    ok = (pid >= 0) & (pid < size)
    np.minimum.at(out, pid[ok], _keys(depth, payload)[ok])
    return out


def _planes(fb_d, fb_p):
    return _keys(np.asarray(fb_d), np.asarray(fb_p))


def _stream(seed, n, oob=0.0, depth_levels=None, pid_range=SIZE):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, pid_range, n).astype(np.int32)
    drop = rng.random(n) < oob
    pid[drop] = SIZE  # the frames' "dropped" sentinel
    depth = rng.integers(0, 1 << 31, n).astype(np.uint32)
    if depth_levels:
        depth = (depth % depth_levels).astype(np.uint32)
    payload = rng.integers(0, 1 << 24, n).astype(np.uint32)
    return pid, depth, payload


def _merge_all(parts, size=SIZE):
    fb = (jnp.full((size,), EMPTY, jnp.uint32),) * 2
    for pid, depth, payload in parts:
        fb = jax.jit(merge_u64_min)(*fb, jnp.asarray(pid), jnp.asarray(depth),
                                    jnp.asarray(payload))
    return fb


@pytest.mark.parametrize("oob", [0.0, 0.4, 0.9, 0.95])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_oob_fractions(seed, oob):
    pid, depth, payload = _stream(seed, 20_000, oob=oob)
    got = _planes(*_merge_all([(pid, depth, payload)]))
    np.testing.assert_array_equal(got, _np_min(pid, depth, payload))


@pytest.mark.parametrize("levels", [1, 3, 50])
def test_merge_depth_ties_break_by_payload(levels):
    """Few distinct depths: the winner is the smallest payload among
    each pixel's nearest points."""
    pid, depth, payload = _stream(7, 30_000, depth_levels=levels,
                                  pid_range=64)
    got = _planes(*_merge_all([(pid, depth, payload)]))
    np.testing.assert_array_equal(got, _np_min(pid, depth, payload))


def test_merge_all_dropped():
    pid, depth, payload = _stream(3, 5000, oob=1.0)
    fb_d, fb_p = _merge_all([(pid, depth, payload)])
    assert (np.asarray(fb_d) == EMPTY).all()
    assert (np.asarray(fb_p) == EMPTY).all()


def test_merge_empty_tiles():
    """Points only in every other 1024-pixel tile; the rest stay empty."""
    pid, depth, payload = _stream(4, 20_000)
    pid = (pid // 1024) * 2048 % SIZE + pid % 1024
    got = _planes(*_merge_all([(pid, depth, payload)]))
    want = _np_min(pid, depth, payload)
    np.testing.assert_array_equal(got, want)
    assert (want.reshape(-1, 1024)[1::2] == ALL).all()


@pytest.mark.parametrize("hot", [1, 16])
def test_merge_heavy_collisions(hot):
    """Tens of thousands of points on a handful of pixels (the close-up
    overdraw case that serializes atomics)."""
    pid, depth, payload = _stream(5, 40_000, pid_range=hot)
    got = _planes(*_merge_all([(pid, depth, payload)]))
    np.testing.assert_array_equal(got, _np_min(pid, depth, payload))


@pytest.mark.parametrize("nparts", [2, 7])
def test_merge_multi_chunk_equals_global(nparts):
    """Merging chunk by chunk into a running framebuffer == one global
    resolve of all points (u64-min is associative over any partition),
    including ties that span chunks."""
    pid, depth, payload = _stream(6, 30_000, oob=0.3, depth_levels=40,
                                  pid_range=512)
    cuts = np.linspace(0, len(pid), nparts + 1).astype(int)
    parts = [(pid[a:b], depth[a:b], payload[a:b])
             for a, b in zip(cuts[:-1], cuts[1:])]
    got = _planes(*_merge_all(parts))
    np.testing.assert_array_equal(got, _np_min(pid, depth, payload))
    gd, gp = scatter_u64_min(jnp.asarray(pid), jnp.asarray(depth),
                             jnp.asarray(payload), SIZE)
    np.testing.assert_array_equal(got, _planes(gd, gp))


def test_merge_into_prefilled_framebuffer():
    """A pixel whose depth improves drops its old payload; a tie keeps
    the smaller one."""
    fb_d = jnp.asarray(np.array([10, 10, 10, EMPTY], np.uint32))
    fb_p = jnp.asarray(np.array([5, 5, 5, EMPTY], np.uint32))
    pid = jnp.asarray(np.array([0, 1, 2, 3], np.int32))
    depth = jnp.asarray(np.array([9, 10, 10, 7], np.uint32))
    payload = jnp.asarray(np.array([99, 3, 8, 1], np.uint32))
    d, p = merge_u64_min(fb_d, fb_p, pid, depth, payload)
    np.testing.assert_array_equal(np.asarray(d), [9, 10, 10, 7])
    np.testing.assert_array_equal(np.asarray(p), [99, 3, 5, 1])


def _np_hqs(pid, depth, rgba, fb_depth, size=SIZE):
    w = depth.view(np.float32)
    ok = (pid >= 0) & (pid < size)
    old = fb_depth[np.clip(pid, 0, size - 1)].view(np.float32)
    keep = ok & (w <= old * np.float32(1.01))
    out = [np.zeros(size, np.uint32) for _ in range(4)]
    for k, v in enumerate(((rgba & 0xFF), (rgba >> 8) & 0xFF,
                           (rgba >> 16) & 0xFF, np.ones_like(rgba))):
        np.add.at(out[k], pid[keep], v[keep].astype(np.uint32))
    return out


@pytest.mark.parametrize("oob", [0.0, 0.5])
@pytest.mark.parametrize("pid_range", [64, SIZE])
def test_hqs_accumulate_matches_numpy(oob, pid_range):
    rng = np.random.default_rng(11)
    n = 30_000
    pid = rng.integers(0, pid_range, n).astype(np.int32)
    pid[rng.random(n) < oob] = SIZE
    # positive depths clustered near each pixel's minimum so the 1%
    # tolerance both accepts and rejects
    w = (100.0 + rng.random(n) * 3.0).astype(np.float32)
    depth = w.view(np.uint32)
    rgba = rng.integers(0, 1 << 24, n).astype(np.uint32)
    fbd = np.full(SIZE, EMPTY, np.uint32)
    np.minimum.at(fbd, pid[pid < SIZE], depth[pid < SIZE])
    acc = tuple(jnp.zeros((SIZE,), jnp.uint32) for _ in range(4))
    got = jax.jit(hqs_accumulate)(acc, jnp.asarray(pid), jnp.asarray(depth),
                                  jnp.asarray(rgba), jnp.asarray(fbd))
    want = _np_hqs(pid, depth, rgba, fbd)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w_)
    n_kept = int(want[3].sum())
    assert 0 < n_kept < (pid < SIZE).sum()  # the tolerance gate bites


@pytest.mark.parametrize("hqs", [False, True])
def test_reference_resolve_matches_numpy(hqs):
    """The plain reference's own resolve (render/reference.py: a 3-key
    sort for color, its own tolerance gate for HQS) against the NumPy
    models, with depth ties and dropped points."""
    from pcrhpg24_tpu.render.reference import _resolve

    rng = np.random.default_rng(12)
    n = 30_000
    pid = rng.integers(0, SIZE, n).astype(np.int32)
    pid[rng.random(n) < 0.3] = SIZE
    w = (100.0 + rng.integers(0, 60, n) * 0.05).astype(np.float32)
    depth = w.view(np.uint32)
    rgba = rng.integers(0, 1 << 24, n).astype(np.uint32)
    img, fb_d = _resolve(jnp.asarray(pid), jnp.asarray(depth),
                         jnp.asarray(rgba), 64, 64, hqs)
    keys = _np_min(pid, depth, rgba)
    want_d = (keys >> np.uint64(32)).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(fb_d), want_d)
    if hqs:
        r, g, b, cnt = _np_hqs(pid, depth, rgba, want_d)
        c = np.maximum(cnt, 1)
        color = (r // c) | ((g // c) << 8) | ((b // c) << 16)
        want = np.where(cnt > 0, color, BG)
        assert 0 < cnt.sum() < (pid < SIZE).sum()  # the gate bites
    else:
        want = np.where(keys == ALL, BG, (keys & 0xFFFFFFFF).astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(img).reshape(-1), want)
