"""Potree build -> parse -> stream -> render, with LOD cut behavior."""

import numpy as np
import jax.numpy as jnp
import pytest

from pcrhpg24_tpu.engine.debug import Debug
from pcrhpg24_tpu.engine.method import Runtime
from pcrhpg24_tpu.engine.potree_resource import PotreeData
from pcrhpg24_tpu.engine.renderer import Renderer, Setting
from pcrhpg24_tpu.formats.potree import (
    build_potree,
    parse_hierarchy,
    read_metadata,
    read_node_points,
)
from pcrhpg24_tpu.render.methods.loop_nodes import ComputeLoopNodes, ComputeLoopNodesHqs
from pcrhpg24_tpu.utils.synthetic import terrain_cloud

W, H = 192, 108
BG = 0x00443322
SEG = 32768  # chunk granularity of the small-chunk frame variants


def _hqs_accumulate_101010(d, tables, code_nodes, chunks, wvp, fb_d, acc,
                           W, H):
    from pcrhpg24_tpu.render.methods.loop_nodes import eager_hqs_sums

    return eager_hqs_sums(d, tables, code_nodes, chunks, wvp, fb_d, W, H)


@pytest.fixture(scope="module")
def potree_dir(tmp_path_factory):
    xyz, rgb = terrain_cloud(120_000, seed=44, extent=500.0)
    d = tmp_path_factory.mktemp("potree") / "cloud"
    build_potree(str(d), xyz, rgb)
    return str(d)


def test_parse_roundtrip(potree_dir):
    meta = read_metadata(potree_dir)
    nodes = parse_hierarchy(potree_dir, meta)
    assert meta.points == 120_000
    total = sum(n.num_points for n in nodes)
    assert total == 120_000
    # multi-level octree with a real hierarchy
    assert max(n.level for n in nodes) >= 2
    # every node's points lie inside its bbox (loose epsilon for quantization)
    for n in nodes[:10]:
        world, rgba = read_node_points(potree_dir, meta, n)
        if len(world) == 0:
            continue
        assert (world >= n.bbox_min - 1e-6).all()
        assert (world <= n.bbox_max + 1e-6).all()


def test_loop_nodes_renders(potree_dir):
    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=500.0, target=(250, 250, 100)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.wait_loaded(r)
    img = np.asarray(r.loop(m.update, m.render, frames=1))
    assert (img != BG).mean() > 0.03
    p.unload(r)


def test_lod_cut_reduces_nodes(potree_dir):
    """Zoomed far out, small nodes must be culled by the 80 px cut."""
    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=20000.0, target=(250, 250, 100)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.wait_loaded(r)
    r.controls_update()
    from pcrhpg24_tpu.render.methods.loop_nodes import node_levels

    cam = r.camera
    lvl = node_levels(
        cam.view(), cam.proj(), p.bbox_min, p.bbox_max, W, H
    )
    assert (lvl >= 4).sum() > 0, "expected far-away nodes culled"
    img = np.asarray(r.loop(m.update, m.render, frames=1))
    assert img is not None
    p.unload(r)


def test_loop_nodes_hqs(potree_dir):
    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=500.0, target=(250, 250, 100)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodesHqs(r, p)
    m.update(r)
    p.wait_loaded(r)
    img = np.asarray(r.loop(m.update, m.render, frames=1))
    assert (img != BG).mean() > 0.03
    p.unload(r)


def test_synth_potree_and_budget(tmp_path, monkeypatch):
    """Synthetic out-of-core builder produces a valid dataset; a
    residency budget keeps only a coarse-first prefix resident and
    frames render while bins stream in (>HBM-scale behavior, small)."""
    import pcrhpg24_tpu.engine.potree_resource as pr
    from pcrhpg24_tpu.tools.synth_potree import synth_potree

    monkeypatch.setattr(pr, "BIN_POINTS", 40_000)  # many bins, tiny scene

    d = str(tmp_path / "synth")
    synth_potree(d, 250_000, depth=1, inner_n=20_000, verbose=False)
    meta = read_metadata(d)
    nodes = parse_hierarchy(d, meta)
    assert meta.points == sum(n.num_points for n in nodes)
    assert meta.points >= 200_000
    for n in nodes[:3]:
        world, _rgba = read_node_points(d, meta, n)
        assert (world >= n.bbox_min - 1e-6).all()
        assert (world <= n.bbox_max + 1e-6).all()

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=4000.0,
                            target=(2048, 2048, 600)))
    budget = meta.points // 2
    p = PotreeData.create(d, budget_points=budget)
    assert p.resident_limited
    assert sum(n.num_points for n in p.nodes) <= budget
    # the resident prefix is coarse-first: max resident level strictly
    # below the dropped levels' max
    assert min(n.level for n in p.nodes) == 0
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.load(r)
    # frames render DURING streaming (partial residency each frame)
    seen = []
    import time as _t
    for _ in range(50):
        img = np.asarray(r.loop(m.update, m.render, frames=1))
        seen.append(p.nodes_loaded)
        if p.state.name == "LOADED":
            break
        _t.sleep(0.02)
    assert p.state.name == "LOADED"
    assert (img != BG).mean() > 0.01
    p.unload(r)


def test_rows_resolve_matches_scatter(potree_dir):
    """The single-dispatch Potree color frame (render_frame_nodes: plane
    reconstruction + projection + scatter-min merge per live chunk) must
    produce the exact planes of the eager per-chunk scatter reference."""
    from pcrhpg24_tpu.render.methods.loop_las import raster_chunk_101010_nodes
    from pcrhpg24_tpu.render.raster import EMPTY, unswizzle_plane

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=900.0,
                            target=(250, 250, 60)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.wait_loaded(r)
    r.controls_update()
    cam = r.camera
    wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
    from pcrhpg24_tpu.render.camera import batches_in_frustum, frustum_planes
    from pcrhpg24_tpu.render.methods.loop_nodes import node_levels

    nn = p.nodes_loaded
    vis = batches_in_frustum(frustum_planes(np.asarray(wvp)),
                             p.bbox_min[:nn], p.bbox_max[:nn])
    lvl = node_levels(cam.view(), cam.proj(), p.bbox_min[:nn],
                      p.bbox_max[:nn], W, H)
    vis &= lvl < 4
    tables = m._per_point_tables(p.num_points_loaded)
    codes = m._frame_codes(lvl, vis, len(p.nodes))
    d = p.dev
    n_pad = int(d["xyz4"].shape[0])
    assert n_pad % SEG == 0

    # scatter reference
    fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_d, fb_p = raster_chunk_101010_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["nid_pt"],
        tables["bmin_nodes"], tables["bmax_nodes"], codes, wvp,
        jnp.uint32(0), fb_d, fb_p, W, H)

    assert (np.asarray(fb_p) != EMPTY).sum() > 500  # scene actually renders
    # single-dispatch frame: the loop over live chunks must give the
    # same planes, with real chunk-skipping exercised (live list shorter
    # than capacity)
    from pcrhpg24_tpu.render.methods.loop_nodes import render_frame_nodes

    # small chunks force a multi-step scan with real chunk skipping;
    # rebuild the per-chunk XOR bases for this chunk size
    import pcrhpg24_tpu.render.methods.loop_nodes as ln

    m._pt_cache = None
    old_chunk = ln.CHUNK_PTS
    ln.CHUNK_PTS = SEG
    try:
        tables = m._per_point_tables(p.num_points_loaded)
    finally:
        ln.CHUNK_PTS = old_chunk
    chunk_pts, ncap = tables["chunk_pts"], tables["ncap"]
    assert chunk_pts == SEG and ncap >= 2
    starts_, counts_ = tables["starts"], p.node_count[:nn]
    live_mask = np.zeros(ncap, bool)
    for i in np.flatnonzero(vis):
        c0 = int(starts_[i]) // chunk_pts
        c1 = int(starts_[i] + counts_[i] - 1) // chunk_pts
        live_mask[c0 : c1 + 1] = True
    live = np.flatnonzero(live_mask)
    live_idx = np.zeros(ncap, np.int32)
    live_idx[: len(live)] = live
    code_delta, base_code = m._frame_code_deltas(np.asarray(codes), tables)
    assert len(live) < ncap  # some chunks are skipped
    sfd, sfp = render_frame_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["starts_d"],
        code_delta, tables["bmin_delta"], tables["bmax_delta"],
        base_code, tables["base_bmin"], tables["base_bmax"], wvp,
        jnp.asarray(live_idx), jnp.int32(len(live)), W, H, chunk_pts)
    m._pt_cache = None  # drop the SEG-sized cache
    np.testing.assert_array_equal(
        np.asarray(unswizzle_plane(sfp, W, H)), np.asarray(fb_p))
    np.testing.assert_array_equal(
        np.asarray(unswizzle_plane(sfd, W, H)), np.asarray(fb_d))


def test_hqs_single_dispatch_matches_eager(potree_dir):
    """The single-dispatch HQS accumulate (gather-free planes,
    scatter-add sums) must produce the eager scatter-add reference's
    (r,g,b,n) planes exactly."""
    from pcrhpg24_tpu.render.methods.loop_nodes import (
        ComputeLoopNodes, render_frame_nodes_hqs,
    )
    from pcrhpg24_tpu.render.raster import (
        EMPTY, swizzle_plane, unswizzle_plane,
    )

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=900.0,
                            target=(250, 250, 60)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.wait_loaded(r)
    r.controls_update()
    cam = r.camera
    wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
    from pcrhpg24_tpu.render.camera import batches_in_frustum, frustum_planes
    from pcrhpg24_tpu.render.methods.loop_nodes import node_levels

    nn = p.nodes_loaded
    lvl = node_levels(cam.view(), cam.proj(), p.bbox_min[:nn],
                      p.bbox_max[:nn], W, H)
    vis = batches_in_frustum(
        frustum_planes(np.asarray(wvp)), p.bbox_min[:nn], p.bbox_max[:nn]
    ) & (lvl < 4)
    tables = m._per_point_tables(p.num_points_loaded)
    codes = m._frame_codes(lvl, vis, len(p.nodes))
    d = p.dev
    n_pad = int(d["xyz4"].shape[0])

    # depth plane via the eager scatter path
    from pcrhpg24_tpu.render.methods.loop_las import raster_chunk_101010_nodes

    fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_d, fb_p = raster_chunk_101010_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["nid_pt"],
        tables["bmin_nodes"], tables["bmax_nodes"], codes, wvp,
        jnp.uint32(0), fb_d, fb_p, W, H)

    chunks = m._live_chunks(tables["starts"], p.node_count[:nn], vis, n_pad)
    acc0 = [jnp.zeros((W * H,), jnp.uint32) for _ in range(4)]
    want = _hqs_accumulate_101010(d, tables, codes, chunks, wvp, fb_d,
                                  acc0, W, H)

    chunk_pts, ncap = tables["chunk_pts"], tables["ncap"]
    live_idx = np.zeros(ncap, np.int32)
    live_idx[: len(chunks)] = chunks
    code_delta, base_code = m._frame_code_deltas(np.asarray(codes), tables)
    accs = render_frame_nodes_hqs(
        d["xyz4"], d["xyz8"], d["xyz12"], d["rgba"], tables["starts_d"],
        code_delta, tables["bmin_delta"], tables["bmax_delta"],
        base_code, tables["base_bmin"], tables["base_bmax"],
        swizzle_plane(fb_d, W, H, EMPTY), wvp,
        jnp.asarray(live_idx), jnp.int32(len(chunks)), W, H, chunk_pts)
    got = [unswizzle_plane(a, W, H) for a in accs]
    assert int(np.asarray(want[3]).sum()) > 500  # scene contributes
    for k in range(4):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


def test_hqs_overlap_tail_chunks(potree_dir):
    """Clamped last chunk (n_pad % chunk_pts != 0) must not double-count
    the overlap prefix in the HQS sums (the color pass's u64-min is
    idempotent over the overlap; sums are not)."""
    from pcrhpg24_tpu.render.methods.loop_nodes import (
        ComputeLoopNodes, render_frame_nodes_hqs,
    )
    import pcrhpg24_tpu.render.methods.loop_nodes as ln
    from pcrhpg24_tpu.render.methods.loop_las import raster_chunk_101010_nodes
    from pcrhpg24_tpu.render.raster import (
        EMPTY, swizzle_plane, unswizzle_plane,
    )
    from pcrhpg24_tpu.render.camera import batches_in_frustum, frustum_planes
    from pcrhpg24_tpu.render.methods.loop_nodes import node_levels

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=500.0,
                            target=(250, 250, 60)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.wait_loaded(r)
    r.controls_update()
    cam = r.camera
    wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
    nn = p.nodes_loaded
    lvl = node_levels(cam.view(), cam.proj(), p.bbox_min[:nn],
                      p.bbox_max[:nn], W, H)
    vis = batches_in_frustum(
        frustum_planes(np.asarray(wvp)), p.bbox_min[:nn], p.bbox_max[:nn]
    ) & (lvl < 4)
    # shrink the device pad to 4 segments so a 3-segment chunk size makes
    # the LAST chunk clamp into real, visible points (the resource's own
    # 2^20 pad would put the whole overlap in dead padding)
    n_pad = 4 * SEG
    total = int(np.sum(p.node_count[:nn]))
    assert total < n_pad
    p.dev = {kk: v[:n_pad] for kk, v in p.dev.items()}
    d = p.dev
    m._pt_cache = None
    old_chunk = ln.CHUNK_PTS
    ln.CHUNK_PTS = 3 * SEG
    try:
        tables = m._per_point_tables(p.num_points_loaded)
    finally:
        ln.CHUNK_PTS = old_chunk
    chunk_pts, ncap = tables["chunk_pts"], tables["ncap"]
    assert n_pad % chunk_pts != 0 and ncap >= 2
    # the clamped last chunk's overlap prefix must hold VISIBLE points
    codes_np = np.asarray(m._frame_codes(lvl, vis, len(p.nodes)))
    nid_ov = np.asarray(tables["nid_pt"][n_pad - chunk_pts:
                                         (ncap - 1) * chunk_pts])
    assert (codes_np[np.clip(nid_ov, 0, len(codes_np) - 1)] & 1).sum() > 1000
    codes = m._frame_codes(lvl, vis, len(p.nodes))

    fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_d, fb_p = raster_chunk_101010_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["nid_pt"],
        tables["bmin_nodes"], tables["bmax_nodes"], codes, wvp,
        jnp.uint32(0), fb_d, fb_p, W, H)

    # eager reference uses exact per-chunk slices (no overlap);
    # force BOTH tail chunks live
    chunks = np.arange(ncap)
    acc0 = [jnp.zeros((W * H,), jnp.uint32) for _ in range(4)]
    import pcrhpg24_tpu.render.methods.loop_nodes as lnmod
    lnmod.CHUNK_PTS = chunk_pts
    try:
        want = _hqs_accumulate_101010(d, tables, codes, chunks, wvp, fb_d,
                                      acc0, W, H)
    finally:
        lnmod.CHUNK_PTS = old_chunk
    live_idx = np.zeros(ncap, np.int32)
    live_idx[: len(chunks)] = chunks
    code_delta, base_code = m._frame_code_deltas(np.asarray(codes), tables)
    accs = render_frame_nodes_hqs(
        d["xyz4"], d["xyz8"], d["xyz12"], d["rgba"], tables["starts_d"],
        code_delta, tables["bmin_delta"], tables["bmax_delta"],
        base_code, tables["base_bmin"], tables["base_bmax"],
        swizzle_plane(fb_d, W, H, EMPTY), wvp,
        jnp.asarray(live_idx), jnp.int32(len(chunks)), W, H, chunk_pts)
    got = [unswizzle_plane(a, W, H) for a in accs]
    m._pt_cache = None
    assert int(np.asarray(want[3]).sum()) > 500
    for kk in range(4):
        np.testing.assert_array_equal(np.asarray(got[kk]),
                                      np.asarray(want[kk]))


def test_node_budget_parity_and_thinning(potree_dir):
    """Per-node point budget (node_budget): the single-dispatch frame
    must bit-match the eager scatter path under the SAME budget, and
    the budget must actually thin the candidate set."""
    from pcrhpg24_tpu.render.methods.loop_nodes import (
        ComputeLoopNodes, node_budget, render_frame_nodes,
    )
    from pcrhpg24_tpu.render.methods.loop_las import raster_chunk_101010_nodes
    from pcrhpg24_tpu.render.raster import EMPTY, unswizzle_plane
    from pcrhpg24_tpu.render.camera import batches_in_frustum, frustum_planes
    from pcrhpg24_tpu.render.methods.loop_nodes import node_levels

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=500.0,
                            target=(250, 250, 60)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.wait_loaded(r)
    r.controls_update()
    cam = r.camera
    wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
    nn = p.nodes_loaded
    lvl = node_levels(cam.view(), cam.proj(), p.bbox_min[:nn],
                      p.bbox_max[:nn], W, H)
    vis = batches_in_frustum(
        frustum_planes(np.asarray(wvp)), p.bbox_min[:nn], p.bbox_max[:nn]
    ) & (lvl < 4)
    counts = p.node_count[:nn]
    # aggressive density so the tiny test screen actually thins nodes
    take = node_budget(cam.view(), cam.proj(), p.bbox_min[:nn],
                       p.bbox_max[:nn], counts, W, H, density=0.5,
                       min_take=64)
    assert (take < counts).any()  # at least one node is thinned
    tables = m._per_point_tables(p.num_points_loaded)
    codes = m._frame_codes(lvl, vis, len(p.nodes), take)
    d = p.dev
    n_pad = int(d["xyz4"].shape[0])

    # eager scatter reference WITH the budget
    fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_d, fb_p = raster_chunk_101010_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["nid_pt"],
        tables["bmin_nodes"], tables["bmax_nodes"], codes, wvp,
        jnp.uint32(0), fb_d, fb_p, W, H,
        starts_nodes=tables["starts_nodes"])
    # budget-off reference: more (or equal) pixels win
    codes64 = m._frame_codes(lvl, vis, len(p.nodes))
    fb_d0 = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_p0 = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_d0, fb_p0 = raster_chunk_101010_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["nid_pt"],
        tables["bmin_nodes"], tables["bmax_nodes"], codes64, wvp,
        jnp.uint32(0), fb_d0, fb_p0, W, H,
        starts_nodes=tables["starts_nodes"])
    filled = int((np.asarray(fb_p) != EMPTY).sum())
    filled0 = int((np.asarray(fb_p0) != EMPTY).sum())
    assert filled > 500 and filled <= filled0

    # single-dispatch frame with the budget: bit-exact planes
    chunk_pts, ncap = tables["chunk_pts"], tables["ncap"]
    live = m._live_chunks(tables["starts"], counts, vis, n_pad)
    live_idx = np.zeros(ncap, np.int32)
    live_idx[: len(live)] = live
    code_delta, base_code = m._frame_code_deltas(np.asarray(codes), tables)
    sfd, sfp = render_frame_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["starts_d"],
        code_delta, tables["bmin_delta"], tables["bmax_delta"],
        base_code, tables["base_bmin"], tables["base_bmax"], wvp,
        jnp.asarray(live_idx), jnp.int32(len(live)), W, H, chunk_pts,
        sval_delta=tables["sval_delta"], base_sval=tables["base_sval"])
    np.testing.assert_array_equal(
        np.asarray(unswizzle_plane(sfp, W, H)), np.asarray(fb_p))
    np.testing.assert_array_equal(
        np.asarray(unswizzle_plane(sfd, W, H)), np.asarray(fb_d))


def test_compact_frame_matches_direct(potree_dir):
    """The O(visible) compact frame (segment row-gather + event-plane
    reconstruction + scatter-min merge) must bit-match the direct
    budgeted eager-scatter frame — including with a multi-chunk
    compact buffer and a clamped last chunk."""
    import pcrhpg24_tpu.render.methods.loop_nodes as ln
    from pcrhpg24_tpu.render.methods.loop_nodes import (
        COMPACT_SEG, ComputeLoopNodes, node_budget, node_levels,
        render_frame_nodes_compact,
    )
    from pcrhpg24_tpu.render.methods.loop_las import raster_chunk_101010_nodes
    from pcrhpg24_tpu.render.raster import EMPTY, unswizzle_plane
    from pcrhpg24_tpu.render.camera import batches_in_frustum, frustum_planes

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=500.0,
                            target=(250, 250, 60)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.wait_loaded(r)
    r.controls_update()
    cam = r.camera
    wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
    nn = p.nodes_loaded
    lvl = node_levels(cam.view(), cam.proj(), p.bbox_min[:nn],
                      p.bbox_max[:nn], W, H)
    vis = batches_in_frustum(
        frustum_planes(np.asarray(wvp)), p.bbox_min[:nn], p.bbox_max[:nn]
    ) & (lvl < 4)
    take = node_budget(cam.view(), cam.proj(), p.bbox_min[:nn],
                       p.bbox_max[:nn], p.node_count[:nn], W, H,
                       density=0.5, min_take=64)
    assert (take < p.node_count[:nn]).any()
    tables = m._per_point_tables(p.num_points_loaded)
    codes = m._frame_codes(lvl, vis, len(p.nodes), take)
    d = p.dev

    # direct budgeted eager reference
    fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_d, fb_p = raster_chunk_101010_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["nid_pt"],
        tables["bmin_nodes"], tables["bmax_nodes"], codes, wvp,
        jnp.uint32(0), fb_d, fb_p, W, H,
        starts_nodes=tables["starts_nodes"])

    # small chunks force a multi-chunk compact scan with a clamped tail
    old_chunk = ln.CHUNK_PTS
    ln.CHUNK_PTS = 3 * COMPACT_SEG * 8  # 98304
    try:
        ct = m._compact_frame_tables(vis, lvl, take)
    finally:
        ln.CHUNK_PTS = old_chunk
    assert ct is not None and ct["ncap"] >= 2
    sfd, sfp = render_frame_nodes_compact(
        d["xyz4"], d["xyz8"], d["xyz12"], ct["seg_src"], ct["ev_pos"],
        ct["ev_code"], ct["ev_end"], ct["ev_off"], ct["ev_bmin"],
        ct["ev_bmax"], ct["base_ev"], wvp, ct["n_live"],
        W, H, ct["chunk_pts"], COMPACT_SEG)
    got_p = np.asarray(unswizzle_plane(sfp, W, H))
    got_d = np.asarray(unswizzle_plane(sfd, W, H))
    assert (np.asarray(fb_p) != EMPTY).sum() > 500
    np.testing.assert_array_equal(got_p, np.asarray(fb_p))
    np.testing.assert_array_equal(got_d, np.asarray(fb_d))


def test_compact_hqs_matches_eager(potree_dir):
    """Compact HQS sums == eager budgeted scatter-add sums."""
    _compact_hqs_check(potree_dir, density=0.5)


@pytest.mark.parametrize("density", [8.0, 1e6])
def test_compact_hqs_high_density(potree_dir, density):
    """Dense budgets: most nodes keep (nearly) all their points, so
    adjacent nodes share the segment where one ends and the next
    begins.  Each such segment must be copied once — the sums would
    count its points twice otherwise — and the event count must stay
    within its capacity."""
    ct = _compact_hqs_check(potree_dir, density=density)
    segs = np.asarray(ct["seg_src"])[: ct["n_segs"]]
    assert len(np.unique(segs)) == len(segs)


def _compact_hqs_check(potree_dir, density):
    import pcrhpg24_tpu.render.methods.loop_nodes as ln
    from pcrhpg24_tpu.render.methods.loop_nodes import (
        COMPACT_SEG, ComputeLoopNodes, node_budget, node_levels,
        render_frame_nodes_compact_hqs,
    )
    from pcrhpg24_tpu.render.methods.loop_las import raster_chunk_101010_nodes
    from pcrhpg24_tpu.render.raster import (
        EMPTY, swizzle_plane, unswizzle_plane,
    )
    from pcrhpg24_tpu.render.camera import batches_in_frustum, frustum_planes

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=500.0,
                            target=(250, 250, 60)))
    p = PotreeData.create(potree_dir)
    m = ComputeLoopNodes(r, p)
    m.update(r)
    p.wait_loaded(r)
    r.controls_update()
    cam = r.camera
    wvp = jnp.asarray((cam.proj() @ cam.view()).astype(np.float32))
    nn = p.nodes_loaded
    lvl = node_levels(cam.view(), cam.proj(), p.bbox_min[:nn],
                      p.bbox_max[:nn], W, H)
    vis = batches_in_frustum(
        frustum_planes(np.asarray(wvp)), p.bbox_min[:nn], p.bbox_max[:nn]
    ) & (lvl < 4)
    take = node_budget(cam.view(), cam.proj(), p.bbox_min[:nn],
                       p.bbox_max[:nn], p.node_count[:nn], W, H,
                       density=density, min_take=64)
    tables = m._per_point_tables(p.num_points_loaded)
    codes = m._frame_codes(lvl, vis, len(p.nodes), take)
    d = p.dev
    n_pad = int(d["xyz4"].shape[0])

    fb_d = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_p = jnp.full((W * H,), EMPTY, jnp.uint32)
    fb_d, fb_p = raster_chunk_101010_nodes(
        d["xyz4"], d["xyz8"], d["xyz12"], tables["nid_pt"],
        tables["bmin_nodes"], tables["bmax_nodes"], codes, wvp,
        jnp.uint32(0), fb_d, fb_p, W, H,
        starts_nodes=tables["starts_nodes"])

    chunks = m._live_chunks(tables["starts"], p.node_count[:nn], vis, n_pad)
    acc0 = [jnp.zeros((W * H,), jnp.uint32) for _ in range(4)]
    want = _hqs_accumulate_101010(d, tables, codes, chunks, wvp, fb_d,
                                  acc0, W, H)

    old_chunk = ln.CHUNK_PTS
    ln.CHUNK_PTS = 3 * COMPACT_SEG * 8
    try:
        ct = m._compact_frame_tables(vis, lvl, take)
    finally:
        ln.CHUNK_PTS = old_chunk
    assert ct is not None and ct["ncap"] >= 2
    accs = render_frame_nodes_compact_hqs(
        d["xyz4"], d["xyz8"], d["xyz12"], d["rgba"], ct["seg_src"],
        ct["ev_pos"], ct["ev_code"], ct["ev_end"], ct["ev_off"],
        ct["ev_bmin"], ct["ev_bmax"], ct["base_ev"],
        swizzle_plane(fb_d, W, H, EMPTY), wvp, ct["n_live"],
        W, H, ct["chunk_pts"], COMPACT_SEG)
    got = [unswizzle_plane(a, W, H) for a in accs]
    assert int(np.asarray(want[3]).sum()) > 500
    for kk in range(4):
        np.testing.assert_array_equal(np.asarray(got[kk]),
                                      np.asarray(want[kk]))
    return ct


@pytest.mark.parametrize("budget", [0.0, 0.5])
@pytest.mark.parametrize("hqs", [False, True])
def test_method_frame_matches_eager_reference(potree_dir, hqs, budget):
    """loop_nodes / loop_nodes_hqs through the Renderer (single-dispatch
    or compact frame) == the eager per-chunk reference image."""
    from pcrhpg24_tpu.render.methods.loop_nodes import eager_reference

    Runtime.resource = None
    r = Renderer(W, H)
    r.apply_setting(Setting(yaw=0.4, pitch=-0.8, radius=500.0,
                            target=(250, 250, 60)))
    p = PotreeData.create(potree_dir)
    m = (ComputeLoopNodesHqs if hqs else ComputeLoopNodes)(r, p)
    m.update(r)
    p.wait_loaded(r)
    Debug.node_budget = budget
    try:
        img = np.asarray(r.loop(m.update, m.render, frames=1))
        ref = np.asarray(eager_reference(m, r, hqs=hqs))
    finally:
        Debug.node_budget = 0.0
    p.unload(r)
    assert (ref != BG).mean() > 0.03
    np.testing.assert_array_equal(img, ref)
