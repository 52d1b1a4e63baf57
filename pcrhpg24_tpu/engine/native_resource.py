"""Streaming `.tpc` (native format) scene resource.

Same state machine and streaming scheme as HuffmanLasData (see
resource.py), but the device layout feeds the native decoders
(render/native_decode_xla.py): per-batch dense rows (streams padded to
the scene's max group width, code tables, round pointers, start values,
colors).
"""

from __future__ import annotations

import threading
from queue import Empty, Queue

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    RENDER_CHUNK_BATCHES,
    TPU_GROUPS_PER_BATCH,
    TPU_MAX_CODE_LEN,
    WORKGROUP_SIZE,
)
from ..formats.native_file import read_tpc_batch, read_tpc_header
from .resource import Resource, ResourceState, _upload_rows

G = TPU_GROUPS_PER_BATCH
MAXL = TPU_MAX_CODE_LEN


class NativeLasData(Resource):
    BATCHES_PER_TASK = 100

    def __init__(self, path: str, budget_batches: int | None = None):
        """`budget_batches` caps device residency for >HBM datasets:
        the loader streams the first `budget_batches` batches and stops
        (coarse Morton prefix = a spatially complete subsampled cover,
        chunk by chunk).  The resource reports LOADED at the budget;
        `resident_limited` records that the dataset is larger.
        Reference analogue: PotreeData's budgeted bin streaming
        (modules/compute/PotreeData.h:288-311)."""
        self.path = path
        self.header = read_tpc_header(path)
        self.dataset_points = self.header.num_points
        self.dataset_batches = self.header.num_batches
        nb = self.header.num_batches
        if budget_batches is not None:
            nb = min(nb, budget_batches)
        self.resident_limited = nb < self.header.num_batches
        self.num_points = nb * WORKGROUP_SIZE * 64
        self.num_batches = nb
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        self.version = self.header.version
        self.color_fmt = getattr(self.header, "color_fmt", "bc1")
        self.maxw = ((self.header.max_group_words + 127) // 128 + 2) * 128
        self.maxt = (self.header.max_group_words + 127) // 128 + 4
        self.dev: dict[str, jax.Array] = {}
        self.scale = np.asarray(self.header.scale)
        self.offset = np.asarray(self.header.offset)
        self.las_min = np.asarray(self.header.las_min)
        self.bbox_min = np.zeros((self.num_batches, 3), np.float32)
        self.bbox_max = np.zeros((self.num_batches, 3), np.float32)
        from ..render.methods.huffman_tpu import CHUNK as _NCHUNK
        b_pad = -(-self.num_batches // _NCHUNK) * _NCHUNK
        # per-batch i32 anchors for batch-relative (f64-precision) projection
        self.anchor_i = np.zeros((b_pad, 3), np.int64)
        self._queue: Queue = Queue()
        self._thread = None
        self._abort = threading.Event()

    @classmethod
    def create(cls, path: str, budget_batches: int | None = None
               ) -> "NativeLasData":
        return cls(path, budget_batches=budget_batches)

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        self.state = ResourceState.LOADING
        from ..render.methods.huffman_tpu import CHUNK as _NCHUNK
        B = -(-self.num_batches // _NCHUNK) * _NCHUNK
        if self.version == 2:
            from ..formats.native_file import COLOR_WORDS

            self.dev = dict(
                widths=jnp.zeros((B, 3, G, 128), jnp.int32),
                streams=jnp.zeros((B, self.maxt, G, 128), jnp.uint32),
                ptrs=jnp.zeros((B, 1, 64), jnp.int32),
                starts=jnp.zeros((B, 3, G, 128), jnp.int32),
                colors=jnp.zeros((B, COLOR_WORDS[self.color_fmt]),
                                 jnp.uint32),
                bbox_min=jnp.zeros((B, 3), jnp.float32),
                bbox_max=jnp.zeros((B, 3), jnp.float32),
                anchor=jnp.zeros((B, 3), jnp.int32),
            )
        else:
            self.dev = dict(
                lj=jnp.zeros((B, 1, 32), jnp.int32),
                streams=jnp.zeros((B, G, self.maxw), jnp.uint32),
                ptrs=jnp.zeros((B, 384, G), jnp.int32),
                dD=jnp.zeros((B, 1, 128), jnp.int32),
                lut=jnp.zeros((B, 1, 128), jnp.int32),
                starts=jnp.zeros((B, 3, G, 128), jnp.int32),
                colors=jnp.zeros((B, WORKGROUP_SIZE * 64 // 8), jnp.uint32),
                bbox_min=jnp.zeros((B, 3), jnp.float32),
                bbox_max=jnp.zeros((B, 3), jnp.float32),
                anchor=jnp.zeros((B, 3), jnp.int32),
            )
        self._abort.clear()
        self._thread = threading.Thread(target=self._loader_main, daemon=True)
        self._thread.start()

    def _loader_main(self):
        try:
            for start in range(0, self.num_batches, self.BATCHES_PER_TASK):
                if self._abort.is_set():
                    return
                end = min(start + self.BATCHES_PER_TASK, self.num_batches)
                items = [read_tpc_batch(self.path, self.header, i) for i in range(start, end)]
                self._queue.put((start, items))
        except Exception as e:
            self._queue.put(("error", e))

    def unload(self, renderer=None):
        self.state = ResourceState.UNLOADING
        self._abort.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.dev = {}
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        self.state = ResourceState.UNLOADED

    def process(self, renderer=None, max_tasks: int = 8):
        if self.version == 2:
            from ..codec.fixed import pack_fixed_batches as _pack
            keys = ("widths", "streams", "ptrs", "starts")
            packed_kw = dict(maxt=self.maxt)
        else:
            from ..codec.native import pack_native_batches as _pack
            keys = ("lj", "streams", "ptrs", "dD", "lut", "starts")
            packed_kw = dict(maxw=self.maxw)

        for _ in range(max_tasks):
            try:
                item = self._queue.get_nowait()
            except Empty:
                break
            if item[0] == "error":
                raise item[1]
            start, items = item
            nbs = [nb for nb, _c in items]
            packed = _pack(nbs, **packed_kw)
            d = self.dev
            for key in keys:
                d[key] = _upload_rows(d[key], start, jnp.asarray(packed[key]))
            colors = np.stack([c for _nb, c in items]).astype(np.uint32)
            d["colors"] = _upload_rows(d["colors"], start, jnp.asarray(colors))
            # component-wise chain-start minimum: identical for the same
            # batch across formats, so the XLA .huffman path and this one
            # produce bit-identical projections (tests/fbcompare)
            anchors = np.stack([
                np.asarray(nb.start_values).reshape(-1, 3).min(axis=0)
                for nb, _c in items
            ]).astype(np.int64)
            self.anchor_i[start : start + len(items)] = anchors
            d["anchor"] = _upload_rows(
                d["anchor"], start, jnp.asarray(anchors.astype(np.int32))
            )
            for i, (nb, _c) in enumerate(items):
                bmin = nb.bbox_min_i.astype(np.float64) * self.scale + self.offset
                bmax = nb.bbox_max_i.astype(np.float64) * self.scale + self.offset
                self.bbox_min[start + i] = (bmin - self.las_min).astype(np.float32)
                self.bbox_max[start + i] = (bmax - self.las_min).astype(np.float32)
            d["bbox_min"] = _upload_rows(
                d["bbox_min"], start,
                jnp.asarray(self.bbox_min[start : start + len(items)]),
            )
            d["bbox_max"] = _upload_rows(
                d["bbox_max"], start,
                jnp.asarray(self.bbox_max[start : start + len(items)]),
            )
            self.num_batches_loaded = max(self.num_batches_loaded, start + len(items))
            self.num_points_loaded = self.num_batches_loaded * WORKGROUP_SIZE * 64
        if self.num_batches_loaded == self.num_batches:
            self.state = ResourceState.LOADED

    def wait_loaded(self, renderer=None):
        import time

        self.load(renderer)
        while self.state != ResourceState.LOADED:
            self.process(renderer, max_tasks=1_000_000)
            time.sleep(0.01)
        return self


class HuffmanNativeData(NativeLasData):
    """Reference `.huffman` scene on the flagship path, with the
    format conversion at LOAD TIME — no `.tpc` sidecar on disk.

    The loader thread reads reference batch blobs and a worker pool runs
    the fused C++ transcode (native.transcode_ref_batch: reference
    Huffman decode -> fbatch fixed-width re-encode in one call; the
    decoded reference deltas ARE the fixed codec's chain deltas, so no
    coordinate materialization happens).  Decoded geometry is
    bit-identical to the `.huffman` XLA path (same deltas), so the
    framebuffer-equality gates apply unchanged.  Reference ingest
    analogue: modules/compute/HuffmanLasLoader.cpp:81-299 (its loader
    threads + per-frame uploadBatch).

    The per-group stream width is not in the reference header; the
    device stream buffer starts at 1.5x batch 0's width and grows
    (one realloc + copy) if a later batch exceeds it.
    """

    BATCHES_PER_TASK = 32

    def __init__(self, path: str, budget_batches: int | None = None):
        from ..codec.fixed import FixedBatch
        from ..formats.huffman_file import read_batch, read_file_header
        from .. import native as _ncore

        if not _ncore.available():
            raise RuntimeError("native codec core required for the "
                               ".huffman load-time fast path")
        self.path = path
        self.ref_hdr = read_file_header(path)
        self.dataset_batches = self.ref_hdr.num_batches
        nb = self.ref_hdr.num_batches
        if budget_batches is not None:
            nb = min(nb, budget_batches)
        self.resident_limited = nb < self.ref_hdr.num_batches
        self.dataset_points = self.dataset_batches * WORKGROUP_SIZE * 64
        self.num_batches = nb
        self.num_points = self.num_batches * WORKGROUP_SIZE * 64
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        self.version = 2
        self.color_fmt = "bc1"
        b0 = read_batch(path, self.ref_hdr, 0)
        st, wd, pt, mn, mx = _ncore.transcode_ref_batch(b0)
        self._fb0 = (FixedBatch(streams=st, widths=wd,
                                start_values=np.asarray(
                                    b0.start_values, np.int32
                                ).reshape(-1, 3),
                                bbox_min_i=mn, bbox_max_i=mx,
                                round_ptrs=pt),
                     np.asarray(b0.color, np.uint32))
        self.maxt = (st.shape[1] * 3 // 2 + 127) // 128 + 4
        self.maxw = self.maxt * 128
        self.dev = {}
        self.scale = np.asarray(b0.las_scale)
        self.offset = np.asarray(b0.las_offset)
        self.las_min = np.asarray(b0.las_min, np.float64)
        self.bbox_min = np.zeros((self.num_batches, 3), np.float32)
        self.bbox_max = np.zeros((self.num_batches, 3), np.float32)
        from ..render.methods.huffman_tpu import CHUNK as _NCHUNK
        b_pad = -(-self.num_batches // _NCHUNK) * _NCHUNK
        self.anchor_i = np.zeros((b_pad, 3), np.int64)
        self._queue: Queue = Queue()
        self._thread = None
        self._abort = threading.Event()

    def _loader_main(self):
        from concurrent.futures import ThreadPoolExecutor
        import os

        from ..codec.fixed import FixedBatch
        from ..formats.huffman_file import read_batch
        from .. import native as _ncore

        def one(i):
            if i == 0 and self._fb0 is not None:
                return self._fb0
            b = read_batch(self.path, self.ref_hdr, i)
            st, wd, pt, mn, mx = _ncore.transcode_ref_batch(b)
            fb = FixedBatch(
                streams=st, widths=wd,
                start_values=np.asarray(b.start_values,
                                        np.int32).reshape(-1, 3),
                bbox_min_i=mn, bbox_max_i=mx, round_ptrs=pt)
            return fb, np.asarray(b.color, np.uint32)

        try:
            # the C++ transcode releases the GIL (ctypes), so a small
            # pool overlaps IO + conversion; sized to the host
            workers = min(8, os.cpu_count() or 1)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for start in range(0, self.num_batches,
                                   self.BATCHES_PER_TASK):
                    if self._abort.is_set():
                        return
                    end = min(start + self.BATCHES_PER_TASK,
                              self.num_batches)
                    items = list(pool.map(one, range(start, end)))
                    self._queue.put((start, items))
        except Exception as e:
            self._queue.put(("error", e))

    def process(self, renderer=None, max_tasks: int = 8):
        # grow the device stream buffer when a queued task's widest
        # batch exceeds it (rare: the reference header carries no
        # group-width bound, so the initial size is an estimate)
        need = 0
        for _s, items in list(self._queue.queue):
            if isinstance(_s, str):
                continue
            for fb, _c in items:
                nt = (fb.streams.shape[1] + 127) // 128 + 4
                need = max(need, nt)
        if need > self.maxt and "streams" in self.dev:
            old = self.dev["streams"]
            grown = jnp.zeros(
                (old.shape[0], need, G, 128), jnp.uint32
            ).at[:, : old.shape[1]].set(old)
            self.dev["streams"] = grown
            self.maxt = need
            self.maxw = need * 128
        super().process(renderer, max_tasks)
