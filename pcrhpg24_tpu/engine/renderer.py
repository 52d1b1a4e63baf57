"""Offscreen renderer and main loop.

Role-equivalent of the reference's GLFW/ImGui Renderer (reference:
src/Renderer.cpp:109-766) minus the interactive window: owns the camera
+ orbit controls, drives the update/render loop, aggregates frame
timings, and exports frames.  A windowed viewer is intentionally out of
scope for a headless accelerator host; images are rendered offscreen and saved
(the reference itself supports that workflow via its screenshot and
depth-dump paths, Renderer.cpp:94-107, huffman_mem_iter_cuda.h:200-220).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import numpy as np

from ..render.camera import Camera, OrbitControls
from ..render.raster import image_to_rgb8
from ..utils.png import write_png
from .debug import Debug
from .timing import Timings


@dataclass
class View:
    width: int
    height: int
    image: np.ndarray | None = None  # (H, W) u32 last resolved frame


class Renderer:
    def __init__(self, width: int = 1920, height: int = 1080):
        self.width = width
        self.height = height
        self.camera = Camera(width=width, height=height)
        self.controls = OrbitControls()
        self.views = [View(width, height)]
        self.timings = Timings()
        self.frame_count = 0
        self.last_image = None
        self.last_fb = None

    def set_size(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self.camera.width = width
        self.camera.height = height

    def apply_setting(self, setting) -> None:
        """Load a scene Setting's camera preset (main.cpp:215-218)."""
        self.controls.yaw = setting.yaw
        self.controls.pitch = setting.pitch
        self.controls.radius = setting.radius
        self.controls.target = np.asarray(setting.target, np.float64)

    def loop(self, update, render, frames: int = 1, block: bool = True):
        """Run `frames` iterations of update+render (Renderer.cpp:239-766).

        `render` returns a device image; with `block` the frame time
        includes device completion (the GLTimerQueries equivalent).
        """
        for _ in range(frames):
            with self.timings.span("frame"):
                self.controls_update()
                with self.timings.span("update"):
                    update(self)
                with self.timings.span("render"):
                    img = render(self)
                    if (Debug.edl and img is not None
                            and self.last_fb is not None
                            and self.last_fb[0] is not None):
                        from ..render.raster import edl_shade

                        img = edl_shade(
                            img, self.last_fb[0].reshape(-1),
                            self.width, self.height, Debug.edl_strength,
                        )
                    if block and img is not None:
                        jax.block_until_ready(img)
            self.last_image = img
            self.frame_count += 1
            Debug.clear_frame_stats()
        return self.last_image

    def controls_update(self) -> None:
        self.camera.world = self.controls.world()

    def save_screenshot(self, path: str) -> None:
        """Resolve the last frame to a PNG (Renderer.cpp:94-107)."""
        if self.last_image is None:
            raise RuntimeError("no frame rendered yet")
        rgb = np.asarray(image_to_rgb8(self.last_image))
        write_png(path, rgb)

    def save_depth_exr(self, path: str) -> None:
        """Dump the depth channel (huffman_mem_iter_cuda.h:200-220):
        EXR for .exr paths (single Z float channel like the reference's
        tinyexr dump), .npy otherwise."""
        if self.last_fb is None:
            raise RuntimeError("no framebuffer available")
        fb_d, _ = self.last_fb
        if fb_d is None:
            raise RuntimeError("the last frame has no depth plane")
        d = np.asarray(fb_d).view(np.float32).reshape(self.height, self.width)
        d = np.where(
            np.asarray(fb_d).reshape(self.height, self.width) == 0xFFFFFFFF, 0.0, d
        )[::-1]
        if path.endswith(".exr"):
            from ..utils.exr import write_exr_z

            write_exr_z(path, d.astype(np.float32))
        else:
            np.save(path, d)


@dataclass
class Setting:
    """Scene preset (reference: src/main.cpp:66-74)."""

    path_potree: str = ""
    path_las: str = ""
    path_huffman: str = ""
    yaw: float = 0.0
    pitch: float = 0.0
    radius: float = 1.0
    target: tuple = (0.0, 0.0, 0.0)
