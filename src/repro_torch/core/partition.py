"""APCP / KCCP tensor partitioning (Sec. IV-A/B) and merge (Sec. IV-D).

Shape algebra and torch slicing only; the coding lives in ``nsctc.py``.
Inputs may carry a leading batch dimension (``(B, C, H, W)`` / blocks
``(Q, B, N/k_b, ., .)``) so a whole request batch streams through one coded
program; the single-image ``(C, H, W)`` form works unchanged.

Partition-resident transitions: because decode is linear and the APCP/KCCP
grid tiles the output tensor, the inter-layer decode -> relu -> pool ->
re-encode round trip never needs the merged ``(B, C, H, W)`` tensor.
``partition_channel_merge`` rejoins the KCCP channel groups of each spatial
partition, ``partition_relu_pool`` applies ReLU + max-pool per spatial
partition with halo rows read from the neighbours
(``gather_partition_rows``), and ``partition_apcp_slices`` re-slices the
pooled partitions straight into the next layer's adaptive-padded APCP
parts.  ``partition_transition`` composes them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "ConvGeometry",
    "apcp_partition",
    "kccp_partition",
    "merge_output",
    "block_output_shape",
    "partition_channel_merge",
    "partition_pool_bounds",
    "gather_partition_rows",
    "partition_relu_pool",
    "partition_apcp_slices",
    "partition_transition",
    "np_reference_conv",
]


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """Static geometry of one coded convolution layer."""

    in_channels: int
    out_channels: int
    height: int  # un-padded input H
    width: int
    kernel_h: int
    kernel_w: int
    stride: int = 1
    padding: int = 0
    k_a: int = 1
    k_b: int = 1

    @property
    def padded_h(self) -> int:
        return self.height + 2 * self.padding

    @property
    def padded_w(self) -> int:
        return self.width + 2 * self.padding

    @property
    def out_h(self) -> int:
        return (self.padded_h - self.kernel_h) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.padded_w - self.kernel_w) // self.stride + 1

    @property
    def out_h_padded(self) -> int:
        """H' rounded up to a multiple of k_a (zero-pad rule, Sec. IV-A1)."""
        return -(-self.out_h // self.k_a) * self.k_a

    @property
    def out_h_block(self) -> int:
        return self.out_h_padded // self.k_a

    @property
    def h_hat(self) -> int:
        """Adaptive-padded slice height, eq. (24)."""
        return (self.out_h_block - 1) * self.stride + self.kernel_h

    @property
    def s_hat(self) -> int:
        """Slice stride (start-index step), eq. (25)."""
        return self.out_h_block * self.stride

    @property
    def in_h_needed(self) -> int:
        """Padded input height required so every slice is in-bounds."""
        return (self.k_a - 1) * self.s_hat + self.h_hat

    @property
    def out_c_padded(self) -> int:
        return -(-self.out_channels // self.k_b) * self.k_b

    @property
    def out_c_block(self) -> int:
        return self.out_c_padded // self.k_b


def apcp_partition(x: torch.Tensor, geo: ConvGeometry) -> torch.Tensor:
    """Adaptive-Padding Partitioning (Algorithm 2, lines 1-8).

    ``x``: un-padded ``(C, H, W)`` or batched ``(B, C, H, W)``.  Applies the
    conv padding plus the bottom zero-pad that rounds H' up to a multiple of
    ``k_a``, then slices ``k_a`` overlapping subtensors of height ``h_hat``
    at stride ``s_hat``.  Returns ``(k_a, [B,] C, h_hat, W + 2p)``.
    """
    c, h, w = x.shape[-3:]
    assert (c, h, w) == (geo.in_channels, geo.height, geo.width), ((c, h, w), geo)
    p = geo.padding
    bottom = max(geo.in_h_needed - (h + 2 * p), 0)
    x = F.pad(x, (p, p, p, p + bottom))
    parts = [x[..., i * geo.s_hat: i * geo.s_hat + geo.h_hat, :]
             for i in range(geo.k_a)]
    return torch.stack(parts, dim=0)


def kccp_partition(k: torch.Tensor, geo: ConvGeometry) -> torch.Tensor:
    """Kernel-Channel Partitioning (Algorithm 3, lines 1-6).

    ``k``: filter ``(N, C, K_H, K_W)`` -> ``(k_b, N/k_b, C, K_H, K_W)``
    (N zero-padded up to a multiple of ``k_b`` if needed).
    """
    n, c, kh, kw = k.shape
    assert (n, c, kh, kw) == (geo.out_channels, geo.in_channels,
                              geo.kernel_h, geo.kernel_w)
    pad = geo.out_c_padded - n
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, 0, 0, pad))
    return k.reshape(geo.k_b, geo.out_c_block, c, kh, kw)


def merge_output(blocks: torch.Tensor, geo: ConvGeometry) -> torch.Tensor:
    """Assemble decoded blocks into Y (Algorithm 5, steps 5-6).

    ``blocks``: ``(k_a*k_b, [B,] N/k_b, H'/k_a, W')`` ordered A-major
    (``index = a * k_b + b``).  Returns ``([B,] N, H', W')`` with channel
    and height padding stripped.
    """
    q = geo.k_a * geo.k_b
    assert blocks.shape[0] == q and tuple(blocks.shape[-3:]) == \
        block_output_shape(geo), (blocks.shape, geo)
    if blocks.ndim == 4:
        grid = blocks.reshape(geo.k_a, geo.k_b, geo.out_c_block,
                              geo.out_h_block, geo.out_w)
        y = grid.permute(1, 2, 0, 3, 4).reshape(
            geo.out_c_padded, geo.out_h_padded, geo.out_w)
        return y[: geo.out_channels, : geo.out_h, :]
    b = blocks.shape[1]
    grid = blocks.reshape(geo.k_a, geo.k_b, b, geo.out_c_block,
                          geo.out_h_block, geo.out_w)
    y = grid.permute(2, 1, 3, 0, 4, 5).reshape(
        b, geo.out_c_padded, geo.out_h_padded, geo.out_w)
    return y[:, : geo.out_channels, : geo.out_h, :]


def block_output_shape(geo: ConvGeometry) -> tuple[int, int, int]:
    return (geo.out_c_block, geo.out_h_block, geo.out_w)


# -- partition-resident layer transitions ----------------------------------
def partition_channel_merge(blocks: torch.Tensor, geo: ConvGeometry) -> torch.Tensor:
    """Rejoin the KCCP channel groups of each spatial partition.

    ``blocks``: decoded grid ``(k_a*k_b, [B,] N/k_b, H'/k_a, W')`` ordered
    A-major.  Returns ``(k_a, [B,] N, H'/k_a, W')`` with the zero-padded
    channels of the last group stripped.
    """
    q = geo.k_a * geo.k_b
    assert blocks.shape[0] == q and tuple(blocks.shape[-3:]) == \
        block_output_shape(geo), (blocks.shape, geo)
    grid = blocks.reshape((geo.k_a, geo.k_b) + tuple(blocks.shape[1:]))
    tail = tuple(blocks.shape[-2:])
    if blocks.ndim == 4:
        y = grid.reshape((geo.k_a, geo.out_c_padded) + tail)
        return y[:, : geo.out_channels]
    y = grid.permute(0, 2, 1, 3, 4, 5).reshape(
        (geo.k_a, blocks.shape[1], geo.out_c_padded) + tail)
    return y[:, :, : geo.out_channels]


def partition_pool_bounds(geo: ConvGeometry, pool: int) -> list[tuple[int, int]]:
    """Pooled-row ownership of each spatial partition.

    Partition ``a`` owns the pooled rows whose ``pool``-row window starts
    inside its row range ``[a*hb, (a+1)*hb)``; rows whose window would read
    past ``out_h`` (the merged relu_pool's floor-crop) belong to nobody.
    Returns ``[(lo, hi)] * k_a`` in pooled row coordinates.
    """
    hb = geo.out_h_block
    h_pool = geo.out_h // pool
    bounds = []
    for a in range(geo.k_a):
        lo = min(-(-(a * hb) // pool), h_pool)
        hi = min(-(-((a + 1) * hb) // pool), h_pool)
        bounds.append((lo, max(hi, lo)))
    return bounds


def gather_partition_rows(parts, r0: int, r1: int) -> torch.Tensor:
    """Rows ``[r0, r1)`` of the virtual row-concatenation of the spatial
    partitions (rows on axis -2, ragged row counts allowed) — the
    halo-exchange primitive."""
    assert r0 <= r1, (r0, r1)
    segs = []
    off = 0
    for arr in parts:
        rows = arr.shape[-2]
        s0, s1 = max(r0 - off, 0), min(r1 - off, rows)
        if s0 < s1:
            segs.append(arr[..., s0:s1, :])
        off += rows
    got = sum(s.shape[-2] for s in segs)
    assert got == r1 - r0, f"rows [{r0}, {r1}) exceed the {off} stacked rows"
    if not segs:
        ref = parts[0]
        return ref.new_zeros(tuple(ref.shape[:-2]) + (0, ref.shape[-1]))
    return segs[0] if len(segs) == 1 else torch.cat(segs, dim=-2)


def partition_relu_pool(parts, geo: ConvGeometry, pool: int, *,
                        relu: bool = True):
    """ReLU + ``pool x pool`` max-pool per spatial partition, halos exchanged.

    ``parts``: the ``k_a`` full-channel spatial partitions
    ``([B,] C, hb, W')``.  Each partition pools exactly the rows it owns
    (``partition_pool_bounds``); windows straddling a boundary read halo rows
    from the neighbouring partition(s).  Returns ``(pooled_parts, bounds)``;
    concatenating ``pooled_parts`` on the row axis reproduces
    ``relu_pool(merged)`` exactly.
    """
    assert len(parts) == geo.k_a, (len(parts), geo.k_a)
    if relu:
        parts = [torch.relu(p) for p in parts]
    bounds = partition_pool_bounds(geo, pool)
    if pool == 1:
        return [gather_partition_rows(parts, lo, hi) for lo, hi in bounds], bounds
    wo = parts[0].shape[-1]
    w2 = wo - wo % pool
    pooled = []
    for lo, hi in bounds:
        rows = gather_partition_rows(parts, lo * pool, hi * pool)[..., :w2]
        shape = tuple(rows.shape[:-2]) + (hi - lo, pool, w2 // pool, pool)
        pooled.append(rows.reshape(shape).amax(dim=(-3, -1)))
    return pooled, bounds


def partition_apcp_slices(pooled, geo_next: ConvGeometry) -> torch.Tensor:
    """Re-slice pooled spatial partitions into the next layer's APCP parts.

    ``pooled``: partition-ordered row segments covering pooled rows
    ``[0, geo_next.height)``.  Equivalent to ``apcp_partition`` on the merged
    tensor, assembled from the partitions without merging.  The conv width
    padding is applied once to the partitions up front.  Returns
    ``(k_a_next, [B,] C, h_hat, W + 2*padding)``.
    """
    h = geo_next.height
    assert sum(seg.shape[-2] for seg in pooled) == h, (
        [tuple(seg.shape) for seg in pooled], geo_next)
    assert pooled[0].shape[-1] == geo_next.width, (pooled[0].shape, geo_next)
    p = geo_next.padding
    if p:
        pooled = [F.pad(seg, (p, p)) for seg in pooled]
    ref = pooled[0]

    def zrows(n_rows):
        return ref.new_zeros(tuple(ref.shape[:-2]) + (n_rows, ref.shape[-1]))

    out = []
    for a in range(geo_next.k_a):
        r0 = a * geo_next.s_hat - p
        r1 = r0 + geo_next.h_hat
        top = min(max(-r0, 0), geo_next.h_hat)  # rows above the real region
        s0, s1 = max(r0, 0), min(r1, h)
        mid = max(s1 - s0, 0)  # overlap with the real pooled rows
        bot = geo_next.h_hat - top - mid  # conv padding + adaptive zero-pad
        segs = []
        if top:
            segs.append(zrows(top))
        if mid:
            segs.append(gather_partition_rows(pooled, s0, s1))
        if bot:
            segs.append(zrows(bot))
        out.append(segs[0] if len(segs) == 1 else torch.cat(segs, dim=-2))
    return torch.stack(out, dim=0)


def partition_transition(blocks: torch.Tensor, geo: ConvGeometry, pool: int,
                         geo_next: ConvGeometry, *,
                         relu: bool = False) -> torch.Tensor:
    """Decoded partition grid of layer *i* -> APCP parts of layer *i+1*.

    ``blocks``: ``(k_a*k_b, [B,] N/k_b, H'/k_a, W')``, already ReLU'd when
    ``relu=False`` (the fused transition applies the nonlinearity in the
    decode epilogue).  Channels rejoin per spatial partition, max-pool runs
    per partition with halo rows, and the pooled partitions re-slice into
    ``geo_next``'s adaptive-padded parts; the merged tensor never exists.
    """
    assert geo.out_channels == geo_next.in_channels, (geo, geo_next)
    assert geo_next.height == geo.out_h // pool, (geo, pool, geo_next)
    spatial = partition_channel_merge(blocks, geo)
    if relu:
        spatial = torch.relu(spatial)
    parts = [spatial[a] for a in range(geo.k_a)]
    pooled, _ = partition_relu_pool(parts, geo, pool, relu=False)
    return partition_apcp_slices(pooled, geo_next)


def np_reference_conv(x: np.ndarray, k: np.ndarray, stride: int, padding: int):
    """Tiny O(N*C*H*W*KH*KW) NumPy oracle of eq. (1) for tests."""
    c, h, w = x.shape
    n, c2, kh, kw = k.shape
    assert c == c2
    xp = np.pad(x, ((0, 0), (padding, padding), (padding, padding)))
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    y = np.zeros((n, ho, wo), dtype=np.result_type(x, k))
    for o in range(n):
        for i in range(ho):
            for j in range(wo):
                patch = xp[:, i * stride:i * stride + kh, j * stride:j * stride + kw]
                y[o, i, j] = np.sum(patch * k[o])
    return y
