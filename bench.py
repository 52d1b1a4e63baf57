"""Headline benchmark: fused decode + rasterize, points/sec @1080p.

Builds (once, cached under ./out/) a synthetic Morton-sorted scene in
the native `.tpc` format, loads it fully to the device, then times full
frames of the flagship `huffman_tpu` method — frustum cull + LOD +
decode of every visible batch + exact depth-test rasterize + resolve —
the same per-frame work as the reference's flagship
(modules/huffman_mem_iter_cuda/huffman_mem_iter_cuda.h:192-195).  Set
BENCH_METHOD=reference to bench the reference-format XLA path instead;
BENCH_BATCHES=N scales the scene (N x 65 536 points).

Runs on one NVIDIA GPU and prints ONE JSON line naming the device and
the card's power limit.  Exits non-zero without a GPU and on any failed
gate or stage.  Every view is gated bit for bit against the plain
reference (render/reference.py) on the same device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BENCH_BATCHES = int(os.environ.get("BENCH_BATCHES", "64"))  # x65 536 pts
BENCH_METHOD = os.environ.get("BENCH_METHOD", "native")
WARMUP = 2
FRAMES = 10
REPS = 5
W, H = 1920, 1080
# Camera presets over the seeded 2 km terrain, as keyword arguments of
# engine.renderer.Setting (reference analogue: the settings table,
# src/main.cpp:66-213).  The headline rides the orbit; the close-up and
# the oblique overdraw view guard against the headline silently
# depending on one friendly viewpoint's Morton coherence.
VIEWS = {
    "orbit": dict(yaw=0.5, pitch=-0.9, radius=2500.0,
                  target=(1000.0, 1000.0, 100.0)),
    "closeup": dict(yaw=2.4, pitch=-0.25, radius=180.0,
                    target=(1000.0, 1000.0, 60.0)),
    "oblique": dict(yaw=-1.1, pitch=-0.08, radius=1400.0,
                    target=(1000.0, 1000.0, 40.0)),
}


def build_scene(path: str, num_batches: int) -> str:
    from pcrhpg24_tpu.formats.las import write_las
    from pcrhpg24_tpu.preprocess import preprocess_las, preprocess_las_tpc
    from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud

    las = path + ".las"
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n = num_batches * 65536
        xyz, rgb = terrain_cloud(n, seed=1, extent=2000.0)
        grid = cloud_to_grid(xyz, scale=(0.001, 0.001, 0.001))
        write_las(las, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
        if path.endswith(".tpc"):
            preprocess_las_tpc(las, path, sort=True, verbose=False)
        else:
            preprocess_las(las, path, sort=True, verbose=False)
        os.remove(las)
    return path


def card() -> str:
    """The card's name and power limit (nvidia-smi, no JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def main() -> int:
    import jax

    from pcrhpg24_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print(json.dumps({"error": f"no GPU (found {dev0.platform})"}))
        return 1

    from pcrhpg24_tpu.engine.debug import Debug
    from pcrhpg24_tpu.engine.renderer import Renderer, Setting

    if BENCH_METHOD == "native":
        from pcrhpg24_tpu.engine.native_resource import NativeLasData as Data
        from pcrhpg24_tpu.render.methods.huffman_tpu import HuffmanTpu as MethodCls

        scene = build_scene(f"out/bench_{BENCH_BATCHES}.tpc", BENCH_BATCHES)
    else:
        from pcrhpg24_tpu.engine.resource import HuffmanLasData as Data
        from pcrhpg24_tpu.render.methods.huffman_mem_iter import (
            HuffmanMemIter as MethodCls,
        )

        scene = build_scene(f"out/bench_{BENCH_BATCHES}.huffman", BENCH_BATCHES)

    Debug.lod = 1.0  # decode + rasterize every point of every visible batch
    las = Data.create(scene)
    r = Renderer(W, H)
    r.apply_setting(Setting(**VIEWS["orbit"]))
    m = MethodCls(r, las)
    m.update(r)
    las.wait_loaded(r)
    r.controls_update()
    _, lod_full = m.frame_setup(r)
    pts_per_frame = int(lod_full.astype(np.int64).sum() * 1024)

    views_out = {}
    gates = {}
    detail = {
        "device_frame_ms": None,
        "points_per_frame": pts_per_frame,
        "batches": BENCH_BATCHES,
        "method": BENCH_METHOD,
        "device": {"platform": dev0.platform, "kind": dev0.device_kind,
                   "count": len(jax.devices())},
        "card": card(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "views": views_out,
        "gates": gates,
    }
    result = {
        "metric": "fused huffman decode+rasterize @1920x1080",
        "value": 0.0, "unit": "Gpoints/s", "vs_baseline": 0.0,
        "detail": detail,
    }

    def set_headline(dt):
        pps = pts_per_frame / dt
        result["value"] = round(pps / 1e9, 4)
        result["vs_baseline"] = round(pps / 2e9, 4)
        detail["device_frame_ms"] = round(dt * 1e3, 3)

    def wall_frames(mm):
        """Median wall ms of FRAMES interactive frames (after warm-up)."""
        r.loop(mm.update, mm.render, frames=WARMUP)
        ts = []
        for _ in range(FRAMES):
            r.controls.yaw += 0.001
            t0 = time.perf_counter()
            jax.block_until_ready(r.loop(mm.update, mm.render, frames=1))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    if BENCH_METHOD != "native":
        dt = wall_frames(m)
        set_headline(dt)
        detail["wall_frame_ms"] = round(dt * 1e3, 3)
        print(json.dumps(result), flush=True)
        return 0

    import jax.numpy as jnp

    from pcrhpg24_tpu.formats.native_file import (
        decode_tpc_batch_coords, read_tpc_batch,
    )
    from pcrhpg24_tpu.render.camera import batch_translations
    from pcrhpg24_tpu.render.methods.huffman_tpu import (
        CHUNK, render_frame_native,
    )
    from pcrhpg24_tpu.render.native_decode_xla import (
        decode_fixed, decode_native_xla,
    )
    from pcrhpg24_tpu.render.reference import (
        chain_payload_bc1, reference_image,
    )

    # --- decode gate: the frame's decoder vs the NumPy mirror ---
    nb_gate = min(8, las.num_batches_loaded)
    d = las.dev
    rows = lambda k: d[k][:nb_gate]
    if las.version == 2:
        got = decode_fixed(rows("widths"), rows("streams"), rows("ptrs"),
                           rows("starts"))
    else:
        got = decode_native_xla(rows("lj"), rows("streams"), rows("ptrs"),
                                rows("dD"), rows("lut"), rows("starts"))
    got = np.transpose(np.asarray(got), (0, 3, 4, 1, 2)).reshape(
        nb_gate, 65536, 3)
    host = [read_tpc_batch(scene, las.header, i) for i in range(nb_gate)]
    want = np.stack([decode_tpc_batch_coords(b) for b, _c in host])
    gates["decode"] = "pass" if np.array_equal(got, want) else "FAIL"
    if gates["decode"] != "pass":
        print(json.dumps(dict(result, error="decode gate failed")))
        return 1

    scale = jnp.asarray(las.scale, jnp.float32)
    offset_rel = jnp.asarray(las.offset - las.las_min, jnp.float32)
    las._dev_consts = (scale, offset_rel)

    def frame_inputs():
        cam = r.camera
        fp = np.zeros(40, np.float32)
        fp[0:16] = cam.view().astype(np.float32).reshape(-1)
        fp[16:22] = cam.proj_params().astype(np.float32)
        fp[22] = 1.0
        fp[23] = float(las.num_batches_loaded)
        fp[24:40] = (cam.proj() @ cam.view()).astype(np.float32).reshape(-1)
        tb = batch_translations(
            (cam.proj() @ cam.view()),
            las.anchor_i[: las.dev["anchor"].shape[0]],
            las.scale, las.offset, las.las_min,
        )
        return jnp.asarray(fp), jnp.asarray(tb)

    kw = dict(width=W, height=H, mode="color",
              nchunks=-(-las.num_batches_loaded // CHUNK), cull=True,
              fmt="fixed" if getattr(las, "version", 1) == 2 else "tbatch")

    @jax.jit
    def chain(dev, fp, tb, scale, offset_rel, k):
        # ONE compile for every chain length: k is a runtime trip count
        # of a fori_loop whose body is the full frame graph.  The probe
        # token feeds BOTH the camera params and the decoder's stream
        # pointers so every chained frame re-decodes (otherwise XLA
        # hoists the camera-independent decode out of the loop).
        ptrs0 = dev["ptrs"]

        def body(_i, carry):
            acc, fp0, tok = carry
            devi = dict(dev, ptrs=ptrs0 + tok)
            _fd, _fp2, img = render_frame_native(
                devi, fp0, scale, offset_rel, tb=tb, **kw)
            probe = img[0, 0]
            t1 = jnp.where(probe == jnp.uint32(123456789), 1, 0)
            return (acc + probe,
                    fp + t1.astype(jnp.float32),
                    t1.astype(jnp.int32))

        acc, _fp0, _tok = jax.lax.fori_loop(
            0, k, body, (jnp.uint32(0), fp, jnp.int32(0)))
        return acc

    def time_chain(fpd, tbd):
        """Per-frame ms as the slope between chains of 1 and 1+FRAMES
        frames (median of REPS timings per endpoint)."""
        ts = {}
        for k in (1, 1 + FRAMES):
            kd = jnp.int32(k)
            float(chain(las.dev, fpd, tbd, scale, offset_rel, kd))
            samples = []
            for _rep in range(REPS):
                t0 = time.perf_counter()
                float(chain(las.dev, fpd, tbd, scale, offset_rel, kd))
                samples.append(time.perf_counter() - t0)
            ts[k] = float(np.median(samples))
        return (ts[1 + FRAMES] - ts[1]) / FRAMES

    def resolve_gate(name, fpd, tbd, lodv):
        """The frame (or, above 256 batches, its most populated chunk
        past chunk 0) == the plain reference on the same device."""
        B = las.num_batches_loaded
        if B <= 256:
            sel, nchunks = np.arange(B), kw["nchunks"]
            dev_g, tb_g, fp_g = las.dev, tbd, fpd
        else:
            per = lodv[: (B // CHUNK) * CHUNK].astype(np.int64)
            c = int(per.reshape(-1, CHUNK).sum(axis=1)[1:].argmax()) + 1
            sel, nchunks = np.arange(c * CHUNK, (c + 1) * CHUNK), 1
            dev_g = {k: v[sel[0]: sel[-1] + 1] for k, v in las.dev.items()}
            tb_g = tbd[sel[0]: sel[-1] + 1]
            fp_g = fpd.at[23].set(float(CHUNK))
        _d, _p, img = render_frame_native(
            dev_g, fp_g, scale, offset_rel, tb=tb_g,
            **dict(kw, nchunks=nchunks))
        items = [read_tpc_batch(scene, las.header, int(i)) for i in sel]
        cam = r.camera
        ref = reference_image(
            np.stack([decode_tpc_batch_coords(b) for b, _c in items]),
            np.stack([chain_payload_bc1(c) for _b, c in items]),
            las.anchor_i[sel], lodv[sel], cam.proj() @ cam.view(),
            las.scale, las.offset, las.las_min, W, H, device=dev0)
        ok = np.array_equal(np.asarray(img), ref)
        gates[f"resolve:{name}"] = ("pass" if ok else "FAIL") + (
            " (full frame)" if B <= 256 else f" (chunk {sel[0] // CHUNK})")
        return ok

    for name, view in VIEWS.items():
        r.apply_setting(Setting(**view))
        r.controls_update()
        fpd, tbd = frame_inputs()
        _, lodv = m.frame_setup(r)
        view_pts = int(lodv.astype(np.int64).sum() * 1024)
        dt_view = time_chain(fpd, tbd)
        views_out[name] = {
            "device_frame_ms": round(dt_view * 1e3, 3),
            "visible_points": view_pts,
            "gpts_per_s": round(view_pts / dt_view / 1e9, 4),
        }
        if name == "orbit":
            set_headline(dt_view)
        if not resolve_gate(name, fpd, tbd, lodv):
            print(json.dumps(dict(result, error=f"resolve gate ({name})")))
            return 1
        # BENCH_TRACE=dir: a device trace of the timed chain
        if name == "orbit" and os.environ.get("BENCH_TRACE"):
            with jax.profiler.trace(os.environ["BENCH_TRACE"]):
                float(chain(las.dev, fpd, tbd, scale, offset_rel,
                            jnp.int32(1 + FRAMES)))

    # ---- non-flagship method stages (regression tracking) ----
    methods_out = {}
    detail["methods"] = methods_out
    r.apply_setting(Setting(**VIEWS["orbit"]))
    r.controls_update()
    if BENCH_BATCHES == 64:
        # load-time .huffman path on the SAME scene: equality gate with
        # the .tpc image, conversion rate and its chained frame time
        from pcrhpg24_tpu.engine.native_resource import HuffmanNativeData

        huf = build_scene("out/bench_64.huffman", BENCH_BATCHES)
        t0 = time.perf_counter()
        h = HuffmanNativeData.create(huf)
        h.wait_loaded(r)
        t_conv = time.perf_counter() - t0
        fpd, tbd = frame_inputs()
        _d1, _p1, img_h = render_frame_native(
            h.dev, fpd, scale, offset_rel, tb=tbd, **kw)
        _d2, _p2, img_t = render_frame_native(
            las.dev, fpd, scale, offset_rel, tb=tbd, **kw)
        same = np.array_equal(np.asarray(img_h), np.asarray(img_t))
        gates["huffman_native"] = "pass" if same else "FAIL"
        if not same:
            print(json.dumps(dict(result, error="huffman_native gate")))
            return 1
        las_dev = las.dev
        las.dev = h.dev
        try:
            dt_h = time_chain(fpd, tbd)
        finally:
            las.dev = las_dev
        methods_out["huffman_native"] = {
            "device_frame_ms": round(dt_h * 1e3, 3),
            "gpts_per_s": round(pts_per_frame / dt_h / 1e9, 4),
            "convert_s": round(t_conv, 3),
            "convert_mpts_per_s": round(h.num_points / t_conv / 1e6, 3),
        }
        h.unload(r)

    # wall frames for the remaining families (1M-point scene)
    from pcrhpg24_tpu.engine.las_resources import (
        ComputeLasData, LasStandardData,
    )
    from pcrhpg24_tpu.engine.method import Runtime
    from pcrhpg24_tpu.engine.resource import HuffmanLasData
    from pcrhpg24_tpu.render.methods.compute_2021 import Compute2021Hqs
    from pcrhpg24_tpu.render.methods.huffman_mem_iter import HuffmanMemIter
    from pcrhpg24_tpu.render.methods.loop_las import ComputeLoopLas

    huf16 = build_scene("out/bench_16.huffman", 16)
    las16 = "out/bench_16s.las"
    if not os.path.exists(las16):
        from pcrhpg24_tpu.formats.las import write_las
        from pcrhpg24_tpu.utils.synthetic import cloud_to_grid, terrain_cloud

        xyz, rgb = terrain_cloud(16 * 65536, seed=1, extent=2000.0)
        grid = cloud_to_grid(xyz)
        write_las(las16, grid[:, 0], grid[:, 1], grid[:, 2], rgb)
    for name, MethodC, Res, path in (
            ("huffman_mem_iter", HuffmanMemIter, HuffmanLasData, huf16),
            ("loop_las", ComputeLoopLas, ComputeLasData, las16),
            ("2021_hqs", Compute2021Hqs, LasStandardData, las16)):
        Runtime.resource = None
        data = Res.create(path)
        mm = MethodC(r, data)
        mm.update(r)
        data.wait_loaded(r)
        methods_out[name] = {"wall_frame_ms": round(wall_frames(mm) * 1e3, 3)}
        data.unload(r)
        Runtime.resource = None

    # interactive wall-clock frames of the flagship
    r.apply_setting(Setting(**VIEWS["orbit"]))
    Runtime.resource = las
    detail["wall_frame_ms"] = round(wall_frames(m) * 1e3, 3)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
