#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU.

Drives the flagship frame through the entry points a user calls
(app.build_methods -> Renderer -> HuffmanTpu / HuffmanTpuHqs, and the
Potree methods) and checks every result against a plain reference:

  1. device      platform, card, power limit; no GPU -> exit 2
  2. decode      every batch of a 64-batch (4.19M-point) `.tpc` v2 scene
                 decoded on the card, bit for bit against the NumPy
                 mirror; the decode kernel against decode_fixed_xla
  3. frame       1920x1080 orbit / close-up / oblique color frames and
                 HQS frames against render/reference.py (host-decoded
                 points, one global resolve), run on the GPU (bit-exact)
                 and on the CPU (within CPU_ARITH_TOLERANCE); the
                 `.huffman` load-time conversion against the `.tpc` image
  4. full size   a 1536-batch (100.7M-point) scene through
                 app.build_methods + Renderer.loop: 3 color frames and 1
                 HQS frame, peak device memory, 32 batches re-decoded
  5. potree      a 16M-point synthetic octree, loop_nodes and
                 loop_nodes_hqs with and without node_budget, against
                 the eager per-chunk reference

  --four-cards   only: the sharded flagship (parallel/mesh_native.py)
                 on a dp=4 and a dp=2 x sp=2 mesh of four cards, color
                 and HQS, against the single-card images

Scenes are generated from a seed into ./out/smoke (set-up time).  The
last line of stdout is one JSON object; any failure exits non-zero
without it.  Timings printed here are for orientation, not claims.

Usage:  python3 chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import bench

OUT = os.path.join("out", "smoke")
W, H = 1920, 1080
BG = 0x00443322
FULL_BATCHES = 1536  # 100.7M points
POTREE_POINTS = 16_000_000
FOUR_CARD_BATCHES = 256


def log(*a):
    print(*a, flush=True)


class Timer:
    def __init__(self, what):
        self.what = what

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self.t0
        log(f"  [{self.what}: {self.s:.3f} s]")


def view(name):
    """bench.py's camera preset `name` as a Setting."""
    from pcrhpg24_tpu.engine.renderer import Setting

    return Setting(**bench.VIEWS[name])


def host_batches(path, indices):
    """NumPy-mirror decode of the listed batches of a `.tpc` file ->
    (coords (n,65536,3), bc1 payload (n,65536), anchors (n,3))."""
    from pcrhpg24_tpu.formats.native_file import (
        decode_tpc_batch_coords, read_tpc_batch, read_tpc_header,
    )
    from pcrhpg24_tpu.render.reference import chain_payload_bc1

    hdr = read_tpc_header(path)
    items = [read_tpc_batch(path, hdr, int(i)) for i in indices]
    coords = np.stack([decode_tpc_batch_coords(b) for b, _c in items])
    payload = np.stack([chain_payload_bc1(c) for _b, c in items])
    anchors = np.stack([np.asarray(b.start_values).reshape(-1, 3).min(0)
                        for b, _c in items])
    return coords, payload, anchors


def decode_on_card(las, indices, impl):
    """Decode the listed resident batches -> (n, 65536, 3) chain layout."""
    import jax
    import jax.numpy as jnp

    from pcrhpg24_tpu.render.native_decode_xla import decode_fixed

    idx = jnp.asarray(np.asarray(indices, np.int32))
    d = las.dev
    out = jax.jit(decode_fixed, static_argnames=("impl",))(
        d["widths"][idx], d["streams"][idx], d["ptrs"][idx],
        d["starts"][idx], impl=impl)  # (n, 64, 3, 8, 128)
    out = np.asarray(jax.block_until_ready(out))
    return np.transpose(out, (0, 3, 4, 1, 2)).reshape(len(indices), 65536, 3)


def load_tpc(path):
    from pcrhpg24_tpu.engine.native_resource import NativeLasData

    return NativeLasData.create(path).wait_loaded()


def phase_decode(scene):
    """Every batch on the card == the NumPy mirror, and kernel == XLA."""
    import jax

    from pcrhpg24_tpu.formats.native_file import read_tpc_header

    nb = read_tpc_header(scene).num_batches
    las = load_tpc(scene)
    with Timer("host mirror decode"):
        coords, payload, anchors = host_batches(scene, range(nb))
    got = decode_on_card(las, range(nb), "kernel")
    xla = decode_on_card(las, range(nb), "xla")
    bad = int((got != coords).any(axis=(1, 2)).sum())
    log(f"  decode: {nb} batches, {bad} differ from the mirror; "
        f"kernel == xla: {np.array_equal(got, xla)}")
    assert bad == 0 and np.array_equal(got, xla)

    from pcrhpg24_tpu.render.decode_fixed_triton import decode_fixed_triton
    from pcrhpg24_tpu.render.native_decode_xla import decode_fixed_xla

    d = las.dev
    args = (d["widths"][:nb], d["streams"][:nb], d["ptrs"][:nb],
            d["starts"][:nb])
    for name, fn in (("triton kernel", decode_fixed_triton),
                     ("decode_fixed_xla", jax.jit(decode_fixed_xla))):
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        log(f"  decode {nb} batches, {name}: median wall "
            f"{np.median(ts) * 1e3:.3f} ms")
    return las, (coords, payload, anchors)


def render_view(method, las, setting, lod=1.0):
    """One frame through Renderer.loop -> (image, host lod_n, wvp)."""
    from pcrhpg24_tpu.engine.debug import Debug
    from pcrhpg24_tpu.engine.renderer import Renderer

    r = Renderer(W, H)
    r.apply_setting(setting)
    m = method(r, las)
    Debug.lod = lod
    img = np.asarray(r.loop(m.update, m.render, frames=1))
    _, lod_full = m.frame_setup(r)
    cam = r.camera
    return img, lod_full[: las.num_batches], cam.proj() @ cam.view()


def compare(name, img, ref):
    diff = img != ref
    n = int(diff.sum())
    log(f"  {name}: {int((img != BG).sum())} lit pixels, {n} of "
        f"{img.size} differ from the reference")
    return n


# Frame vs the reference on the CPU: XLA on the CPU contracts a*b+c into
# fused multiply-adds, XLA on the GPU rounds each product and computes
# 1/w approximately (both measured on the H100), so a few projected
# points land one pixel over or win a pixel by an ulp.  The frame must
# equal the same reference run on the GPU bit for bit (the frame's
# logic is exact) and differ from the CPU run in at most this share of
# its lit pixels.
CPU_ARITH_TOLERANCE = 1e-4


def phase_frame(scene, las, host):
    """Color and HQS frames == the plain reference; .huffman == .tpc."""
    import jax

    from pcrhpg24_tpu.engine.method import Runtime
    from pcrhpg24_tpu.render.methods.huffman_tpu import HuffmanTpu
    from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import HuffmanTpuHqs
    from pcrhpg24_tpu.render.reference import reference_image

    coords, payload, anchors = host
    args = (las.scale, las.offset, las.las_min, W, H)
    failed = []
    images = {}
    for name in bench.VIEWS:
        for method, hqs in ((HuffmanTpu, False), (HuffmanTpuHqs, True)):
            Runtime.resource = las
            with Timer(f"{name} {method.__name__} frame (with compile)"):
                img, lod_n, wvp = render_view(method, las, view(name))
            ref = (coords, payload, anchors, lod_n, wvp, *args)
            label = f"{name} {'hqs' if hqs else 'color'}"
            n_gpu = compare(label + " vs reference on the GPU", img,
                            reference_image(*ref, hqs=hqs,
                                            device=jax.devices()[0]))
            n_cpu = compare(label + " vs reference on the CPU", img,
                            reference_image(*ref, hqs=hqs))
            lit = int((img != BG).sum())
            if n_gpu or n_cpu > CPU_ARITH_TOLERANCE * lit or lit < 10_000:
                failed.append(label)
            images[(name, hqs)] = img
    assert not failed, f"frames differ from the reference: {failed}"

    # .huffman through the load-time conversion == the .tpc image
    from pcrhpg24_tpu.engine.native_resource import HuffmanNativeData

    huf = bench.build_scene(os.path.join(OUT, "s64.huffman"), 64)
    with Timer(".huffman load-time conversion"):
        h = HuffmanNativeData.create(huf).wait_loaded()
    Runtime.resource = h
    img_h, _l, _w = render_view(HuffmanTpu, h, view("orbit"))
    n = compare(".huffman vs .tpc orbit", img_h, images[("orbit", False)])
    assert n == 0, ".huffman load-time image differs from the .tpc image"


def phase_full_size(num_batches):
    """app.build_methods + Renderer.loop at 100.7M points."""
    import jax

    from pcrhpg24_tpu.app import build_methods
    from pcrhpg24_tpu.engine.debug import Debug
    from pcrhpg24_tpu.engine.method import Runtime
    from pcrhpg24_tpu.engine.renderer import Renderer

    with Timer(f"build {num_batches}-batch scene (set-up)"):
        scene = bench.build_scene(
            os.path.join(OUT, f"s{num_batches}.tpc"), num_batches)
    r = Renderer(W, H)
    r.apply_setting(view("orbit"))
    Debug.lod = 1.0
    methods = {m.name: m for m in build_methods(r, scene)}
    color, hqs = methods["huffman_tpu"], methods["huffman_tpu_hqs"]
    with Timer("load to the card"):
        color.update(r)
        color.las.wait_loaded(r)
    las = color.las
    log(f"  resident: {las.num_batches_loaded} batches, "
        f"{las.num_points_loaded} points")
    lit = 0
    for i in range(4):
        m = color if i < 3 else hqs
        r.controls.yaw += 0.002
        t0 = time.perf_counter()
        img = r.loop(m.update, m.render, frames=1)
        jax.block_until_ready(img)
        dt = time.perf_counter() - t0
        lit = int((np.asarray(img) != BG).sum())
        log(f"  frame {i} ({m.name}): {dt * 1e3:.3f} ms wall"
            f"{' (includes compile)' if i in (0, 3) else ''}, "
            f"{lit} lit pixels")
        assert lit > W * H // 20, "full-size frame is (nearly) empty"
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    idx = np.linspace(0, num_batches - 1, 32).astype(int)
    coords, _p, _a = host_batches(scene, idx)
    got = decode_on_card(las, idx, "kernel")
    assert np.array_equal(got, coords), "full-size decode differs"
    log(f"  32 spread batches decode bit-exact")
    las.unload(r)
    Runtime.clear()


def phase_potree(points):
    """loop_nodes(_hqs), with and without node_budget == eager reference."""
    from pcrhpg24_tpu.engine.debug import Debug
    from pcrhpg24_tpu.engine.method import Runtime
    from pcrhpg24_tpu.engine.potree_resource import PotreeData
    from pcrhpg24_tpu.engine.renderer import Renderer, Setting
    from pcrhpg24_tpu.render.methods.loop_nodes import (
        ComputeLoopNodes, ComputeLoopNodesHqs, eager_reference,
    )
    from pcrhpg24_tpu.tools.synth_potree import synth_potree

    d = os.path.join(OUT, f"potree_{points}")
    with Timer(f"synthesize {points}-point octree (set-up)"):
        if not os.path.exists(os.path.join(d, "metadata.json")):
            synth_potree(d, points, verbose=False)
    Runtime.clear()
    p = PotreeData.create(d)
    failed = []
    for cls, hqs in ((ComputeLoopNodes, False), (ComputeLoopNodesHqs, True)):
        for budget in (0.0, 2.0):
            r = Renderer(W, H)
            r.apply_setting(Setting(yaw=0.4, pitch=-0.7, radius=5000.0,
                                    target=(2048.0, 2048.0, 600.0)))
            m = cls(r, p)
            m.update(r)
            p.wait_loaded(r)
            Debug.node_budget = budget
            try:
                with Timer(f"{m.name} budget={budget} frame"):
                    img = np.asarray(r.loop(m.update, m.render, frames=1))
                ref = np.asarray(eager_reference(m, r, hqs=hqs))
            finally:
                Debug.node_budget = 0.0
            label = f"{m.name} budget={budget}"
            if compare(label, img, ref) or (img != BG).sum() < 10_000:
                failed.append(label)
    p.unload(None)
    assert not failed, f"potree frames differ: {failed}"


def phase_four_cards(num_batches):
    """Sharded color + HQS on 4 cards == the single-card images."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pcrhpg24_tpu.engine.renderer import Renderer
    from pcrhpg24_tpu.parallel.mesh_native import (
        _DEV_SPEC_KEYS, make_flagship_hqs, make_flagship_render,
    )
    from pcrhpg24_tpu.render.camera import batch_translations
    from pcrhpg24_tpu.render.methods.huffman_tpu import (
        CHUNK, render_frame_native,
    )
    from pcrhpg24_tpu.render.methods.huffman_tpu_hqs import hqs_frame_native

    devs = jax.devices()
    assert len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}"
    scene = bench.build_scene(
        os.path.join(OUT, f"s{num_batches}.tpc"), num_batches)
    las = load_tpc(scene)  # on card 0
    r = Renderer(W, H)
    r.apply_setting(view("orbit"))
    r.controls_update()
    cam = r.camera
    fp = np.zeros(40, np.float32)
    fp[0:16] = cam.view().astype(np.float32).reshape(-1)
    fp[16:22] = cam.proj_params().astype(np.float32)
    fp[22] = 1.0
    fp[23] = float(num_batches)
    fp[24:40] = (cam.proj() @ cam.view()).astype(np.float32).reshape(-1)
    tb = batch_translations(cam.proj() @ cam.view(), las.anchor_i,
                            las.scale, las.offset, las.las_min)
    fpd, tbd = jnp.asarray(fp), jnp.asarray(tb)
    scale = jnp.asarray(las.scale, jnp.float32)
    off = jnp.asarray(las.offset - las.las_min, jnp.float32)
    nchunks = -(-num_batches // CHUNK)
    _d, _p, single = render_frame_native(
        las.dev, fpd, scale, off, width=W, height=H, mode="color",
        nchunks=nchunks, cull=True, points=64, fmt="fixed", tb=tbd)
    _d, _n, single_h = hqs_frame_native(
        las.dev, fpd, scale, off, W, H, nchunks, True, "fixed", tbd, 64)
    single, single_h = np.asarray(single), np.asarray(single_h)
    failed = []
    for dp, sp in ((4, 1), (2, 2)):
        mesh = Mesh(np.asarray(devs[:4]).reshape(dp, sp), ("dp", "sp"))
        shard = NamedSharding(mesh, P("dp"))
        dev = {k: jax.device_put(np.asarray(las.dev[k][:num_batches]), shard)
               for k in _DEV_SPEC_KEYS}
        tbs = jax.device_put(tb[:num_batches], shard)
        for kind, mk, ref in (("color", make_flagship_render, single),
                              ("hqs", make_flagship_hqs, single_h)):
            fn = jax.jit(mk(mesh, W, H))
            with Timer(f"dp={dp} sp={sp} {kind} (with compile)"):
                img = np.asarray(fn(dev, fpd, scale, off, tbs))
            label = f"dp={dp} sp={sp} {kind}"
            if compare(label, img, ref) or (img != BG).sum() < 10_000:
                failed.append(label)
    assert not failed, f"sharded frames differ: {failed}"
    return 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    from pcrhpg24_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    d0 = devs[0]
    log(f"platform={d0.platform} kind={d0.device_kind} count={len(devs)} "
        f"jax={jax.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} compile_cache={cache}")
    if d0.platform != "gpu":
        print(f"no GPU: JAX found {d0.platform} devices only", file=sys.stderr)
        return 2
    card = bench.card()
    log(f"card: {card}")
    os.makedirs(OUT, exist_ok=True)

    t_start = time.perf_counter()
    if args.four_cards:
        phases = [("four cards",
                   lambda: phase_four_cards(FOUR_CARD_BATCHES))]
    else:
        scene = bench.build_scene(os.path.join(OUT, "s64.tpc"), 64)
        state = {}

        def decode():
            state["las"], state["host"] = phase_decode(scene)

        phases = [
            ("decode", decode),
            ("frame", lambda: phase_frame(scene, state["las"],
                                          state["host"])),
            ("full size", lambda: phase_full_size(FULL_BATCHES)),
            ("potree", lambda: phase_potree(POTREE_POINTS)),
        ]
    failed = []
    for name, fn in phases:
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report every phase, then fail
            import traceback

            traceback.print_exc()
            failed.append(name)
            log(f"  FAILED: {type(e).__name__}: {e}")
        log(f"  ({time.perf_counter() - t0:.1f} s)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
