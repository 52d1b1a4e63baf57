"""LAS -> `.huffman` preprocessor (reference: src/preprocess.cpp).

Pipeline per chunk of up to MAX_POINTS_PER_BATCH points
(preprocess.cpp:925-1165): read LAS records, pad the tail batch by
repeating the last point, Morton-sort, split into 65 536-point batches,
per batch delta+clipped-Huffman encode the coordinates and BC1-encode
the colors, and serialize BatchDump blobs.

Usage: python -m pcrhpg24_tpu.preprocess input.las out.huffman [sort 0|1]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .codec.batch_codec import encode_batch
from .codec.bc1 import encode_bc1
from .codec.morton import morton_order
from .constants import (
    CLUSTERS_PER_THREAD,
    MAX_POINTS_PER_BATCH,
    POINTS_PER_THREAD,
    POINTS_PER_WORKGROUP,
    WORKGROUP_SIZE,
)
from .formats.huffman_file import BatchDump, write_huffman_file
from .formats.las import read_header, read_points


def preprocess_chunk(x, y, z, color, las_header, point_offset, sort=True):
    """Encode one chunk into BatchDump list; pads to a batch multiple."""
    n = len(x)
    pad = (-n) % POINTS_PER_WORKGROUP
    if pad:
        x = np.concatenate([x, np.full(pad, x[-1], x.dtype)])
        y = np.concatenate([y, np.full(pad, y[-1], y.dtype)])
        z = np.concatenate([z, np.full(pad, z[-1], z.dtype)])
        color = np.concatenate([color, np.full(pad, color[-1], color.dtype)])
        n += pad

    if sort:
        order = morton_order(x, y, z)
        x, y, z, color = x[order], y[order], z[order], color[order]

    h = las_header
    batches = []
    for start in range(0, n, POINTS_PER_WORKGROUP):
        sl = slice(start, start + POINTS_PER_WORKGROUP)
        eb = encode_batch(x[sl], y[sl], z[sl])
        col = encode_bc1(color[sl])
        # world-space bbox: float32(int) * scale + offset (preprocess.cpp:1082-1087)
        bmin = (
            eb.bbox_min_i.astype(np.float32).astype(np.float64) * h.scale + h.offset
        ).astype(np.float32)
        bmax = (
            eb.bbox_max_i.astype(np.float32).astype(np.float64) * h.scale + h.offset
        ).astype(np.float32)
        batches.append(
            BatchDump(
                point_offset=point_offset + start,
                num_points=POINTS_PER_WORKGROUP,
                num_threads=WORKGROUP_SIZE,
                points_per_thread=POINTS_PER_THREAD,
                clusters_per_thread=CLUSTERS_PER_THREAD,
                las_scale=h.scale,
                las_offset=h.offset,
                bbox_min=bmin,
                bbox_max=bmax,
                las_min=h.cmin.astype(np.float32),
                las_max=h.cmax.astype(np.float32),
                start_values=eb.start_values,
                separate_sizes=eb.separate_sizes,
                decoder_values=eb.decoder_values,
                decoder_cw_len=eb.decoder_cw_len,
                cluster_sizes=eb.cluster_sizes,
                encoding=eb.encoding,
                separate=eb.separate,
                color=col,
            )
        )
    return batches


def preprocess_las(las_path: str, out_path: str, sort: bool = True, verbose=True):
    header = read_header(las_path)
    n_total = header.num_points
    batches: list[BatchDump] = []
    point_offset = 0
    t0 = time.time()
    for start in range(0, n_total, MAX_POINTS_PER_BATCH):
        count = min(MAX_POINTS_PER_BATCH, n_total - start)
        pts = read_points(las_path, start, count)
        chunk = preprocess_chunk(
            pts.x, pts.y, pts.z, pts.color, header, point_offset, sort
        )
        batches.extend(chunk)
        point_offset += sum(b.num_points for b in chunk)
        if verbose:
            print(f"chunk {start // MAX_POINTS_PER_BATCH}: {len(chunk)} batches, "
                  f"{time.time() - t0:.1f}s elapsed")
    write_huffman_file(out_path, batches)

    if verbose:
        ng_old = 12.0 * point_offset
        ng_new = sum(
            4 * (len(b.encoding) + len(b.separate) + len(b.decoder_values) * 2
                 + len(b.cluster_sizes)) + 12 * WORKGROUP_SIZE + 4 * WORKGROUP_SIZE
            for b in batches
        )
        nc_old = 3.0 * point_offset
        nc_new = sum(4 * len(b.color) for b in batches)
        print(f"Number of Points: {point_offset}")
        print(f"Number of Batches: {len(batches)}")
        print(f"Geometry Compression Ratio: {ng_old / ng_new:.3f}")
        print(f"Color Compression Ratio: {nc_old / nc_new:.3f}")
        print(f"Total Compression Ratio: {(ng_old + nc_old) / (ng_new + nc_new):.3f}")
    return out_path


def preprocess_las_tpc(las_path: str, out_path: str, sort: bool = True,
                       verbose=True, codec: str = "fixed",
                       color_fmt: str = "bc1"):
    """LAS -> `.tpc` (native format).

    codec="fixed" writes v2 fbatch blobs (fixed-width, fastest decode —
    the flagship format); codec="huffman" writes v1 bucket-Huffman
    tbatch blobs (~13% smaller, slower decode).

    color_fmt selects the color payload encoding — the reference's
    compile-time COLOR_COMPRESSION 0|1|7 (modules/compute/Resources.h:15)
    as a per-file option: "bc1" (default, 0.5 B/pt), "bc7" (mode 6,
    1 B/pt, higher quality), "raw" (4 B/pt, lossless).
    """
    from .codec.fixed import encode_fixed_batch
    from .codec.native import encode_native_batch
    from .formats.native_file import write_tpc

    encode = encode_fixed_batch if codec == "fixed" else encode_native_batch
    if color_fmt == "bc1":
        cenc = encode_bc1
    elif color_fmt == "bc7":
        from .codec.bc7 import encode_bc7 as cenc
    elif color_fmt == "raw":
        cenc = lambda c: (np.asarray(c, np.uint32) & 0xFFFFFF)
    else:
        raise ValueError(f"unknown color_fmt {color_fmt!r}")
    if color_fmt != "bc1" and codec != "fixed":
        raise ValueError("raw/BC7 colors require the fixed (v2) codec")

    header = read_header(las_path)
    n_total = header.num_points
    batches, colors = [], []
    for start in range(0, n_total, MAX_POINTS_PER_BATCH):
        count = min(MAX_POINTS_PER_BATCH, n_total - start)
        pts = read_points(las_path, start, count)
        x, y, z, color = pts.x, pts.y, pts.z, pts.color
        pad = (-len(x)) % POINTS_PER_WORKGROUP
        if pad:
            x = np.concatenate([x, np.full(pad, x[-1], x.dtype)])
            y = np.concatenate([y, np.full(pad, y[-1], y.dtype)])
            z = np.concatenate([z, np.full(pad, z[-1], z.dtype)])
            color = np.concatenate([color, np.full(pad, color[-1], color.dtype)])
        if sort:
            order = morton_order(x, y, z)
            x, y, z, color = x[order], y[order], z[order], color[order]
        for s in range(0, len(x), POINTS_PER_WORKGROUP):
            sl = slice(s, s + POINTS_PER_WORKGROUP)
            batches.append(encode(x[sl], y[sl], z[sl]))
            colors.append(cenc(color[sl]))
        if verbose:
            print(f"tpc chunk {start // MAX_POINTS_PER_BATCH}: {len(batches)} batches")
    write_tpc(
        out_path, batches, colors, header.scale, header.offset,
        header.cmin, header.cmax, color_fmt=color_fmt,
    )
    if verbose:
        total_words = sum(nb.total_words for nb in batches)
        n = len(batches) * POINTS_PER_WORKGROUP
        geo = 4 * total_words + (12 + 4 * 384 * 8 // 1024) * WORKGROUP_SIZE * len(batches)
        print(f"Number of Points: {n}")
        print(f"Number of Batches: {len(batches)}")
        print(f"Geometry Compression Ratio: {12.0 * n / geo:.3f}")
    return out_path


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    las_path, out_path = argv[0], argv[1]
    sort = bool(int(argv[2])) if len(argv) > 2 else True
    color_fmt = argv[3] if len(argv) > 3 else "bc1"
    if out_path.endswith(".tpc"):
        preprocess_las_tpc(las_path, out_path, sort, color_fmt=color_fmt)
    else:
        preprocess_las(las_path, out_path, sort)
    return 0


if __name__ == "__main__":
    sys.exit(main())
