"""K compare-exchange stages over int32 keys: the roofline's calibration
kernel.

Counterpart of `ccve_tpu.bench.roofline.measure_anchors`' inner
`make_ce_kernel(K)`: `ce_stages_i32(x, K)` (kernel csrc/ce_stages.cu)
runs K stages; stage s compare-exchanges element i with i ^ k, k = 1 <<
(s % 3), the element with bit k clear taking the min. Its K-slope prices
one stage of the port's tile sort (`bench.roofline.measure_anchors`).
`ce_stages_plain` is the torch twin, for the tests and for CPU tensors.
"""

from __future__ import annotations

import torch

from ccve_tpu_torch.kernels import _build

# the kernel's tile (2^13 keys, kernels/bigsort.py's TILE_LOG), fixed in
# csrc/ce_stages.cu; the result does not depend on it
TILE_LOG = 13


def ce_stages_plain(x: torch.Tensor, n_stages: int) -> torch.Tensor:
    """`ce_stages_i32` in torch ops, on any device: per stage a view of
    pairs `[-1, 2, k]`, then min and max."""
    for s in range(n_stages):
        k = 1 << (s % 3)
        pairs = x.view(-1, 2, k)
        lo, hi = pairs[:, 0], pairs[:, 1]
        x = torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi)], dim=1).view(-1)
    return x.clone() if n_stages == 0 else x


def ce_stages_i32(x: torch.Tensor, n_stages: int) -> torch.Tensor:
    """int32[n]: `n_stages` compare-exchange stages of int32[n] `x`, n a
    multiple of 2^TILE_LOG."""
    _build.check_i32(x, "x")
    if x.numel() % (1 << TILE_LOG):
        raise ValueError(f"length {x.numel()} is not a multiple of 2^{TILE_LOG}")
    if n_stages < 0:
        raise ValueError(f"n_stages {n_stages} < 0")
    if x.device.type == "cpu":
        return ce_stages_plain(x, n_stages)
    y = torch.empty_like(x)
    if not x.numel():
        return y
    code = _build.load().ccve_ce_stages_i32(
        x.data_ptr(), y.data_ptr(), x.numel() >> TILE_LOG, n_stages, _build.stream(x)
    )
    _build.check(code, "ce_stages_i32")
    ce_stages_i32.launches += 1
    return y


ce_stages_i32.launches = 0
