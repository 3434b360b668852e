"""Order-keeping stream compaction of int32 planes by a mask.

Counterpart of `ccve_tpu.kernels.compact.pallas_compact_i32`:
`compact_i32` (kernel csrc/compact.cu) packs the rows where the mask holds
to the front of each plane, in their order, and returns their count. It
takes any n (the TPU kernel wants a multiple of 128). Slots past the count
hold 0: on the card the kernel writes them, one launch a call, so the
output is allocated, not zeroed.
"""

from __future__ import annotations

import torch

from ccve_tpu_torch.kernels import _build


def _check(planes: torch.Tensor, mask: torch.Tensor) -> None:
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.int32:
        raise TypeError(f"planes: expected an int32 tensor, got {getattr(planes, 'dtype', type(planes))}")
    if planes.dim() != 2 or planes.shape[0] < 1:
        raise ValueError(f"planes: expected [C >= 1, n], got {tuple(planes.shape)}")
    if not planes.is_contiguous():
        raise ValueError("planes: expected a contiguous tensor")
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError("mask: expected a 1-D bool tensor")
    if mask.numel() != planes.shape[1] or mask.device != planes.device:
        raise ValueError(
            f"mask has {mask.numel()} values on {mask.device}, planes "
            f"{planes.shape[1]} on {planes.device}"
        )
    if not mask.is_contiguous():
        raise ValueError("mask: expected a contiguous tensor")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {planes.device}")
    if planes.shape[1] >= 2**31:
        raise ValueError(f"{planes.shape[1]} elements, the kernel takes < 2^31")


def compact_plain(planes: torch.Tensor, mask: torch.Tensor):
    """`compact_i32` as boolean indexing, on any device."""
    kept = planes[:, mask]
    out = torch.zeros_like(planes)
    out[:, : kept.shape[1]] = kept
    return out, mask.sum()


def compact_i32(planes: torch.Tensor, mask: torch.Tensor):
    """(int32[C, n], count): the rows j of `planes` (int32[C, n]) with
    mask[j] (bool[n]) packed to the front, order kept, zeros after; count
    is an int64 scalar tensor on the planes' device."""
    _check(planes, mask)
    if planes.device.type == "cpu":
        return compact_plain(planes, mask)
    n_planes, n = planes.shape
    if not n:
        return torch.empty_like(planes), torch.zeros((), dtype=torch.int64, device=planes.device)
    lib = _build.load()
    # the kernel writes every slot of out; the count and the look-back's
    # scratch share one allocation, the scratch 16 bytes in
    out = torch.empty_like(planes)
    buf = torch.empty(2 + -(-lib.ccve_compact_scratch_bytes(n) // 8), dtype=torch.int64,
                      device=planes.device)
    count = buf[0]
    code = lib.ccve_compact_i32(
        planes.data_ptr(), mask.data_ptr(), n, n_planes, buf.data_ptr() + 16,
        out.data_ptr(), count.data_ptr(), _build.stream(planes),
    )
    _build.check(code, "compact_i32")
    compact_i32.launches += 1
    return out, count


compact_i32.launches = 0
