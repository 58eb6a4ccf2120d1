"""Static bucket layout: flatten a parameter dict into fixed-size buckets.

Port of ``repro/comm/bucketize.py``. A :class:`BucketLayout` is computed once
per parameter spec and drives flatten/unflatten. Leaves are grouped by dtype
(first-appearance order), concatenated in the dict's order, zero-padded to a
whole number of ``bucket_size``-element buckets and viewed as
``(n_buckets, bucket_size)``; only the last bucket of a group is padded.

Leaf order is the trap: the port's buckets must hold the reference's
elements in the reference's places, or every per-bucket scale, and so the
whole trajectory, differs. The reference flattens in ``jax.tree.flatten``
order (dict keys sorted, list order kept, each leaf C-order). The port's
parameter dicts are built in exactly that order
(:func:`repro_torch.models.transformer.tree_paths`), with block parameters
stacked over layers as the reference stacks them, so flattening is a
concatenation in dict order.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

DEFAULT_BUCKET_SIZE = 1 << 16  # 65536 elems = 256 KiB fp32


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside its dtype group's flat span."""

    name: str
    group: int
    offset: int
    size: int
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class BucketGroup:
    """One dtype-homogeneous run of buckets."""

    dtype: torch.dtype
    valid: int  # true element count (before padding)
    n_buckets: int


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    bucket_size: int
    slots: tuple[LeafSlot, ...]
    groups: tuple[BucketGroup, ...]

    @property
    def n_buckets(self) -> int:
        return sum(g.n_buckets for g in self.groups)


Tree = Mapping[str, torch.Tensor]


def build_layout(tree: Tree, bucket_size: int = DEFAULT_BUCKET_SIZE) -> BucketLayout:
    """The static bucket layout of an ordered name → tensor dict."""
    if bucket_size <= 0 or bucket_size % 32 != 0:
        raise ValueError(f"bucket_size must be a positive multiple of 32, got {bucket_size}")
    order: list[torch.dtype] = []
    sizes: dict[torch.dtype, int] = {}
    slots = []
    for name, leaf in tree.items():
        if leaf.dtype not in sizes:
            order.append(leaf.dtype)
            sizes[leaf.dtype] = 0
        slots.append(LeafSlot(name, order.index(leaf.dtype), sizes[leaf.dtype], leaf.numel(),
                              tuple(leaf.shape), leaf.dtype))
        sizes[leaf.dtype] += leaf.numel()
    groups = tuple(
        BucketGroup(dt, sizes[dt], max(1, -(-sizes[dt] // bucket_size))) for dt in order
    )
    return BucketLayout(bucket_size, tuple(slots), groups)


def flatten_buckets(layout: BucketLayout, tree: Tree) -> tuple[torch.Tensor, ...]:
    """Dict → one ``(n_buckets, bucket_size)`` fp32 tensor per dtype group.

    Each group is one allocation: leaves are copied into their slots and only
    the padded tail is zeroed.
    """
    if list(tree) != [s.name for s in layout.slots]:
        raise ValueError("tree names/order differ from the layout's")
    device = next(iter(tree.values())).device
    flats = []
    for group in layout.groups:
        flat = torch.empty(group.n_buckets * layout.bucket_size, dtype=torch.float32, device=device)
        flat[group.valid:].zero_()
        flats.append(flat)
    for slot in layout.slots:
        leaf = tree[slot.name]
        if tuple(leaf.shape) != slot.shape:
            raise ValueError(f"{slot.name}: shape {tuple(leaf.shape)} != layout {slot.shape}")
        flats[slot.group][slot.offset : slot.offset + slot.size].copy_(leaf.reshape(-1))
    return tuple(f.view(g.n_buckets, layout.bucket_size) for f, g in zip(flats, layout.groups))


def unflatten_buckets(layout: BucketLayout, buckets: tuple[torch.Tensor, ...]) -> Tree:
    """Inverse of :func:`flatten_buckets`; fp32 leaves are views into the buckets."""
    if len(buckets) != len(layout.groups):
        raise ValueError(f"got {len(buckets)} bucket arrays, layout has {len(layout.groups)}")
    flats = []
    for group, b in zip(layout.groups, buckets):
        if tuple(b.shape) != (group.n_buckets, layout.bucket_size):
            raise ValueError(
                f"bucket array {tuple(b.shape)} != ({group.n_buckets}, {layout.bucket_size})"
            )
        flats.append(b.reshape(-1))
    return {
        s.name: flats[s.group][s.offset : s.offset + s.size].view(s.shape).to(s.dtype)
        for s in layout.slots
    }


def valid_mask(layout: BucketLayout, group_index: int, device=None) -> torch.Tensor:
    """(n_buckets, bucket_size) fp32 mask: 1 on real elements, 0 on padding."""
    group = layout.groups[group_index]
    idx = torch.arange(group.n_buckets * layout.bucket_size, device=device)
    return (idx < group.valid).to(torch.float32).view(group.n_buckets, layout.bucket_size)
