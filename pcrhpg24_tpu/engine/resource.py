"""Resource state machine and the streaming `.huffman` scene resource.

Role-equivalent of the reference's Resource interface + HuffmanLasData
(reference: modules/compute/Resources.h:20-40, modules/compute/
HuffmanLasLoader.{h,cpp}): a header-driven preallocation of flat device
buffers, a detached loader thread that reads batch blobs from disk, and
a per-frame `process()` that uploads pending batches into device-buffer
slices via append cursors.

Here "cuMemAlloc + cuMemcpyHtoD slice" becomes preallocated
jax device arrays updated in place with donated-buffer
`lax.dynamic_update_slice` jits, so streaming does not reallocate
device memory.
"""

from __future__ import annotations

import threading
from enum import Enum
from functools import partial
from queue import Empty, Queue

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import RENDER_CHUNK_BATCHES, WARP_SIZE, WARPS_PER_BATCH, WORKGROUP_SIZE
from ..formats.huffman_file import BatchDump, read_batch, read_file_header


class ResourceState(Enum):
    UNLOADED = 0
    LOADING = 1
    LOADED = 2
    UNLOADING = 3


class Resource:
    state: ResourceState = ResourceState.UNLOADED

    def load(self, renderer):  # pragma: no cover - interface
        raise NotImplementedError

    def unload(self, renderer):
        raise NotImplementedError

    def process(self, renderer):
        raise NotImplementedError


@partial(jax.jit, donate_argnums=(0,))
def _upload_1d(buf, start, vals):
    return jax.lax.dynamic_update_slice(buf, vals, (start,))


@partial(jax.jit, donate_argnums=(0,))
def _upload_rows(buf, start, vals):
    idx = (start,) + (0,) * (buf.ndim - 1)
    return jax.lax.dynamic_update_slice(buf, vals, idx)


class HuffmanLasData(Resource):
    """Streaming `.huffman` scene with flat device buffers.

    Device layout mirrors the reference's nine cuMemAlloc buffers
    (HuffmanLasLoader.cpp:32-77): encoding, separate, per-batch decoder
    tables, cluster sizes, separate sizes, start values, colors, and
    batch metadata, each indexed through per-batch offsets.
    """

    BATCHES_PER_TASK = 100  # loader granularity (HuffmanLasLoader.cpp:81-149)

    def __init__(self, path: str):
        self.path = path
        self.header = read_file_header(path)
        self.num_points = self.header.num_points
        self.num_batches = self.header.num_batches
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        self.dev: dict[str, jax.Array] = {}
        self.scale = None
        self.offset = None
        self.las_min = None
        self.bbox_min = np.zeros((self.num_batches, 3), np.float32)
        self.bbox_max = np.zeros((self.num_batches, 3), np.float32)
        b_pad = -(-self.num_batches // RENDER_CHUNK_BATCHES) * RENDER_CHUNK_BATCHES
        # per-batch i32 anchors for batch-relative (f64-precision) projection
        self.anchor_i = np.zeros((b_pad, 3), np.int64)
        self._queue: Queue = Queue()
        self._thread: threading.Thread | None = None
        self._abort = threading.Event()
        self._enc_cursor = 0
        self._sep_cursor = 0

    @classmethod
    def create(cls, path: str) -> "HuffmanLasData":
        return cls(path)

    # -- loading ---------------------------------------------------------

    def load(self, renderer=None):
        if self.state != ResourceState.UNLOADED:
            return
        self.state = ResourceState.LOADING
        # pad batch-row arrays to the render chunk size so chunked
        # dynamic slices never run past the end
        B = -(-self.num_batches // RENDER_CHUNK_BATCHES) * RENDER_CHUNK_BATCHES
        h = self.header
        enc_words = h.encoding_bytes // 4 + 2 * WARP_SIZE  # overread pad
        sep_words = max(h.separate_bytes // 4, 1)
        self.dev = dict(
            encoding=jnp.zeros(enc_words, jnp.uint32),
            enc_offsets=jnp.zeros(B, jnp.int32),
            cluster_sizes=jnp.zeros((B, WARPS_PER_BATCH), jnp.int32),
            separate=jnp.zeros(sep_words, jnp.int32),
            sep_offsets=jnp.zeros(B, jnp.int32),
            separate_sizes=jnp.zeros((B, WORKGROUP_SIZE), jnp.int32),
            table_values=jnp.zeros((B, 4096), jnp.int32),
            table_cw_len=jnp.zeros((B, 4096), jnp.int32),
            start_values=jnp.zeros((B, WORKGROUP_SIZE, 3), jnp.int32),
            colors=jnp.zeros((B, WORKGROUP_SIZE * 64 // 8), jnp.uint32),
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
                dumps = [read_batch(self.path, self.header, i) for i in range(start, end)]
                self._queue.put((start, dumps))
        except Exception as e:  # surface loader errors on the render thread
            self._queue.put(("error", e))

    def unload(self, renderer=None):
        self.state = ResourceState.UNLOADING
        self._abort.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.dev = {}
        self.num_batches_loaded = 0
        self.num_points_loaded = 0
        self._enc_cursor = 0
        self._sep_cursor = 0
        self.state = ResourceState.UNLOADED

    # -- per-frame upload -----------------------------------------------

    def process(self, renderer=None, max_tasks: int = 8):
        """Drain loaded batch groups into device buffers (append cursors)."""
        for _ in range(max_tasks):
            try:
                item = self._queue.get_nowait()
            except Empty:
                break
            if item[0] == "error":
                raise item[1]
            start, dumps = item
            self._upload_group(start, dumps)
        if self.num_batches_loaded == self.num_batches:
            self.state = ResourceState.LOADED

    def _upload_group(self, start: int, dumps: list[BatchDump]):
        n = len(dumps)
        if self.scale is None:
            self.scale = np.asarray(dumps[0].las_scale)
            self.offset = np.asarray(dumps[0].las_offset)
            self.las_min = np.asarray(dumps[0].las_min, np.float64)

        enc = np.concatenate([np.asarray(d.encoding, np.uint32) for d in dumps])
        sep_parts = [np.asarray(d.separate, np.int32) for d in dumps]
        sep = (
            np.concatenate(sep_parts)
            if any(len(s) for s in sep_parts)
            else np.zeros(0, np.int32)
        )
        enc_offs = self._enc_cursor + np.concatenate(
            [[0], np.cumsum([len(d.encoding) for d in dumps])[:-1]]
        ).astype(np.int32)
        sep_offs = self._sep_cursor + np.concatenate(
            [[0], np.cumsum([len(s) for s in sep_parts])[:-1]]
        ).astype(np.int32)

        d = self.dev
        d["encoding"] = _upload_1d(d["encoding"], self._enc_cursor, jnp.asarray(enc))
        if len(sep):
            d["separate"] = _upload_1d(d["separate"], self._sep_cursor, jnp.asarray(sep))
        d["enc_offsets"] = _upload_1d(d["enc_offsets"], start, jnp.asarray(enc_offs))
        d["sep_offsets"] = _upload_1d(d["sep_offsets"], start, jnp.asarray(sep_offs))
        d["cluster_sizes"] = _upload_rows(
            d["cluster_sizes"], start,
            jnp.asarray(np.stack([d_.cluster_sizes for d_ in dumps]).astype(np.int32)),
        )
        d["separate_sizes"] = _upload_rows(
            d["separate_sizes"], start,
            jnp.asarray(np.stack([d_.separate_sizes for d_ in dumps]).astype(np.int32)),
        )
        d["table_values"] = _upload_rows(
            d["table_values"], start,
            jnp.asarray(np.stack([d_.decoder_values for d_ in dumps]).astype(np.int32)),
        )
        d["table_cw_len"] = _upload_rows(
            d["table_cw_len"], start,
            jnp.asarray(np.stack([d_.decoder_cw_len for d_ in dumps]).astype(np.int32)),
        )
        d["start_values"] = _upload_rows(
            d["start_values"], start,
            jnp.asarray(
                np.stack([np.asarray(d_.start_values).reshape(-1, 3) for d_ in dumps]).astype(np.int32)
            ),
        )
        d["colors"] = _upload_rows(
            d["colors"], start,
            jnp.asarray(np.stack([d_.color for d_ in dumps]).astype(np.uint32)),
        )
        # anchor: exact per-batch i32 reference point (reference format has
        # no integer bbox; the component-wise start_values minimum serves)
        anchors = np.stack([
            np.asarray(d_.start_values).reshape(-1, 3).min(axis=0)
            for d_ in dumps
        ]).astype(np.int64)
        self.anchor_i[start : start + n] = anchors
        d["anchor"] = _upload_rows(
            d["anchor"], start, jnp.asarray(anchors.astype(np.int32))
        )

        for i, dump in enumerate(dumps):
            # render frame is world - las_min (render.cu:336-341)
            self.bbox_min[start + i] = dump.bbox_min - self.las_min.astype(np.float32)
            self.bbox_max[start + i] = dump.bbox_max - self.las_min.astype(np.float32)
        self._enc_cursor += len(enc)
        self._sep_cursor += len(sep)
        self.num_batches_loaded = max(self.num_batches_loaded, start + n)
        self.num_points_loaded = self.num_batches_loaded * WORKGROUP_SIZE * 64

    def wait_loaded(self, renderer=None):
        """Block until fully loaded (bench convenience)."""
        self.load(renderer)
        while self.state != ResourceState.LOADED:
            self.process(renderer, max_tasks=1_000_000)
        return self
