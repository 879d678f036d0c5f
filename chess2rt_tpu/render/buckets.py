"""Bucket decomposition (renderer.d:194-213).

The reference splits the frame into bucketSize^2 rectangles visited in a
zigzag (boustrophedon) row order — a cache/NUMA-friendly scan for its
thread pool.  On the device the wavefront renders the whole frame at once, so
buckets survive as (a) the progressive-display order for interactive
preview streaming and (b) the pixel-slab decomposition behind
SceneStatic.chunk_pixels.  This module reproduces the exact reference
bucket list for parity and for consumers that want progressive order.
"""

from __future__ import annotations

from typing import List, NamedTuple


class Bucket(NamedTuple):
    x0: int
    y0: int
    x1: int  # exclusive, clipped to the frame
    y1: int


def get_buckets_list(frame_width: int, frame_height: int, bucket_size: int = 48) -> List[Bucket]:
    """Zigzag bucket rectangles, clipped to the frame (renderer.d:194-213:
    even rows left->right, odd rows right->left)."""
    bw = (frame_width - 1) // bucket_size + 1
    bh = (frame_height - 1) // bucket_size + 1
    out: List[Bucket] = []
    for y in range(bh):
        xs = range(bw) if y % 2 == 0 else range(bw - 1, -1, -1)
        for x in xs:
            out.append(
                Bucket(
                    x * bucket_size,
                    y * bucket_size,
                    min((x + 1) * bucket_size, frame_width),
                    min((y + 1) * bucket_size, frame_height),
                )
            )
    return out
