"""Application entry: scene settings, method registry, render loop.

Role-equivalent of the reference's src/main.cpp: builds the renderer,
registers every method applicable to the scene's format, applies a
camera preset, and runs the loop — headless, with PNG/EXR-npy export
(the reference's interactive ImGui window maps to the CLI/debug flags).

Usage:
  python -m pcrhpg24_tpu.app --scene out/scene.tpc [--method huffman_tpu]
      [--frames 3] [--width 1920 --height 1080]
      [--yaw -0.15 --pitch -0.57 --radius 3166 --target x y z]
      [--screenshot out/frame.png] [--depth out/depth.npy]
      [--lod 0.1] [--colorize-chunks] [--colorize-overdraw] [--show-num-points] [--list-methods]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .engine.debug import Debug
from .engine.method import Runtime
from .engine.renderer import Renderer, Setting


def build_methods(renderer: Renderer, scene_path: str):
    """Instantiate the loaders + methods for a scene (main.cpp:244-274)."""
    Runtime.clear()
    if scene_path.endswith(".tpc"):
        from .engine.native_resource import NativeLasData
        from .render.methods.huffman_tpu import HuffmanTpu

        from .render.methods.huffman_tpu_hqs import HuffmanTpuHqs

        data = NativeLasData.create(scene_path)
        Runtime.add_method(HuffmanTpu(renderer, data))
        Runtime.add_method(HuffmanTpuHqs(renderer, data))
    elif scene_path.endswith(".huffman"):
        from .engine.resource import HuffmanLasData
        from .render.methods.huffman_hqs import HuffmanHQS
        from .render.methods.huffman_mem_iter import HuffmanMemIter

        data = HuffmanLasData.create(scene_path)
        Runtime.add_method(HuffmanMemIter(renderer, data))
        Runtime.add_method(HuffmanHQS(renderer, data))
        # reference scenes also get the flagship path through LOAD-TIME
        # conversion (fused C++ transcode on the loader pool, no .tpc
        # on disk); decoded geometry is bit-identical to the XLA path
        from .engine.native_resource import HuffmanNativeData
        from .render.methods.huffman_tpu import HuffmanTpu

        Runtime.add_method(
            HuffmanTpu(renderer, HuffmanNativeData.create(scene_path)))
    elif (scene_path.endswith(".laz") or "," in scene_path
          or "*" in scene_path):
        # multi-file / compressed ingestion (LasLoaderSparse equivalent:
        # modules/compute/LasLoaderSparse.cpp) — renders through the
        # basic method on the concatenated scene
        from .engine.las_sparse import LasSparseData
        from .render.methods.basic import BasicMethod

        data = LasSparseData.create(scene_path)
        Runtime.add_method(BasicMethod(renderer, data))
    elif scene_path.endswith(".las"):
        from .engine.las_resources import (
            ComputeLasData,
            ComputeLasDataBasic,
            LasStandardData,
        )
        from .render.methods.basic import BasicMethod
        from .render.methods.compute_2021 import Compute2021, Compute2021Hqs
        from .render.methods.loop_las import (
            ComputeLoopLas,
            ComputeLoopLas2,
            ComputeLoopLasHqs,
        )

        d1010 = ComputeLasData.create(scene_path)
        basic = ComputeLasDataBasic.create(scene_path)
        std = LasStandardData.create(scene_path)
        Runtime.add_method(ComputeLoopLas(renderer, d1010))
        Runtime.add_method(ComputeLoopLas2(renderer, d1010))
        Runtime.add_method(ComputeLoopLasHqs(renderer, d1010))
        Runtime.add_method(BasicMethod(renderer, basic))
        for name in Compute2021.VARIANTS:
            Runtime.add_method(Compute2021(renderer, std, name=name))
        Runtime.add_method(Compute2021Hqs(renderer, std))
    elif scene_path == "parametric":
        from .render.methods.parametric import Parametric

        Runtime.add_method(Parametric(renderer))
    else:  # potree directory
        from .engine.potree_resource import PotreeData
        from .render.methods.loop_nodes import ComputeLoopNodes, ComputeLoopNodesHqs

        data = PotreeData.create(scene_path)
        Runtime.add_method(ComputeLoopNodes(renderer, data))
        Runtime.add_method(ComputeLoopNodesHqs(renderer, data))
    return Runtime.methods


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--method", default=None)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--yaw", type=float, default=-0.15)
    ap.add_argument("--pitch", type=float, default=-0.57)
    ap.add_argument("--radius", type=float, default=1000.0)
    ap.add_argument("--target", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--lod", type=float, default=0.1)
    ap.add_argument("--screenshot", default=None)
    ap.add_argument("--depth", default=None)
    ap.add_argument("--colorize-chunks", action="store_true")
    ap.add_argument("--colorize-overdraw", action="store_true")
    ap.add_argument("--edl", action="store_true",
                    help="eye-dome lighting in the resolve "
                         "(resolve.cs:143-188)")
    ap.add_argument("--show-num-points", action="store_true")
    ap.add_argument("--no-frustum-culling", action="store_true")
    ap.add_argument("--show-bounding-box", action="store_true")
    ap.add_argument("--list-methods", action="store_true")
    ap.add_argument("--stats", action="store_true", help="print timing report")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler device trace of the "
                         "rendered frames into DIR (open with xprof/"
                         "tensorboard; the GLTimerQueries equivalent "
                         "with per-kernel attribution)")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="interactive localhost viewer instead of offscreen frames")
    args = ap.parse_args(argv)

    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    Debug.lod = args.lod
    Debug.colorize_chunks = args.colorize_chunks
    Debug.colorize_overdraw = args.colorize_overdraw
    Debug.edl = args.edl
    Debug.show_num_points = args.show_num_points
    Debug.frustum_culling_enabled = not args.no_frustum_culling
    Debug.show_bounding_box = args.show_bounding_box

    renderer = Renderer(args.width, args.height)
    renderer.apply_setting(
        Setting(yaw=args.yaw, pitch=args.pitch, radius=args.radius, target=args.target)
    )
    build_methods(renderer, args.scene)

    if args.list_methods:
        for m in Runtime.methods:
            print(f"{m.name:24s} [{m.group}] {m.description}")
        return 0

    if args.method:
        Runtime.set_selected(args.method)
    method = Runtime.selected

    if args.serve is not None:
        from .engine.viewer import ViewerServer

        method.update(renderer)
        if hasattr(method, "las"):
            method.las.wait_loaded(renderer)
        elif hasattr(method, "potree"):
            method.potree.wait_loaded(renderer)
        ViewerServer(renderer, Runtime.methods, args.serve).serve_forever()
        return 0

    print(f"rendering {args.frames} frame(s) with {method.name}")

    method.update(renderer)
    if hasattr(method, "las"):
        method.las.wait_loaded(renderer)
    elif hasattr(method, "potree"):
        method.potree.wait_loaded(renderer)
    if args.trace:
        import jax

        # warm frame first so the trace holds steady-state kernels,
        # not compilation
        renderer.loop(method.update, method.render, frames=1)
        with jax.profiler.trace(args.trace):
            renderer.loop(method.update, method.render, frames=args.frames)
        print(f"wrote device trace to {args.trace}")
    else:
        renderer.loop(method.update, method.render, frames=args.frames)

    if args.screenshot:
        renderer.save_screenshot(args.screenshot)
        print(f"wrote {args.screenshot}")
    if args.depth:
        renderer.save_depth_exr(args.depth)
        print(f"wrote {args.depth}")
    if args.stats:
        print(renderer.timings.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
