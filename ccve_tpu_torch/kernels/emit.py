"""The emission of a sorted join level: the output rows from the
compacted triples.

Port-only: the JAX package emits a level of `bulk_materialize` with takes
and concatenations (`ccve_tpu.exec.bulk.bulk_materialize`), no Pallas
kernel. `emit_rows_i32` (kernel csrc/emit.cu) takes #9's compacted planes
of one level (int32[3, N]: probe row, key', payload; the first `n_keep`
slots hold the matches), the partial output rows `state` (int64[rows, W])
and the join column `level`, and writes each output row once:
state[row, :] with column `level` set to the key (key = key' + kmin - 1),
then (key, payload), or (0, key) without `full`.
"""

from __future__ import annotations

import torch

from ccve_tpu_torch.kernels import _build

I64_MIN = -(2**63)


def _check(planes: torch.Tensor, n_keep: int, kmin: int, state: torch.Tensor, level: int):
    if not isinstance(planes, torch.Tensor) or planes.dtype != torch.int32:
        raise TypeError(f"planes: expected an int32 tensor, got {getattr(planes, 'dtype', type(planes))}")
    if planes.dim() != 2 or planes.shape[0] != 3 or not planes.is_contiguous():
        raise ValueError(f"planes: expected a contiguous [3, N], got {tuple(planes.shape)}")
    if planes.shape[1] >= 2**31:
        raise ValueError(f"{planes.shape[1]} slots, the kernel takes < 2^31")
    if not isinstance(state, torch.Tensor) or state.dtype != torch.int64:
        raise TypeError(f"state: expected an int64 tensor, got {getattr(state, 'dtype', type(state))}")
    if state.dim() != 2 or not state.is_contiguous():
        raise ValueError(f"state: expected a contiguous [rows, W], got {tuple(state.shape)}")
    if state.device != planes.device or planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"planes on {planes.device}, state on {state.device}")
    if not 0 <= n_keep <= planes.shape[1]:
        raise ValueError(f"n_keep {n_keep} outside [0, {planes.shape[1]}]")
    if not 0 <= level < state.shape[1]:
        raise ValueError(f"level {level} outside the state's {state.shape[1]} columns")
    if not I64_MIN <= kmin < 2**63:
        raise ValueError(f"kmin {kmin} is no int64")


def emit_rows_plain(planes: torch.Tensor, n_keep: int, kmin: int, state: torch.Tensor,
                    level: int, full: bool) -> torch.Tensor:
    """`emit_rows_i32` as a gather and a concatenation, on any device."""
    rows = planes[0, :n_keep].to(torch.int64)
    # key' >= 1 on a match, so key' - 1 + kmin stays in the int64 range
    key = (planes[1, :n_keep].to(torch.int64) - 1) + kmin
    new = (key, planes[2, :n_keep].to(torch.int64)) if full else (torch.zeros_like(key), key)
    out = torch.cat([state[rows], new[0][:, None], new[1][:, None]], dim=1)
    out[:, level] = key
    return out


def emit_rows_i32(planes: torch.Tensor, n_keep: int, kmin: int, state: torch.Tensor,
                  level: int, full: bool) -> torch.Tensor:
    """int64[n_keep, W + 2]: for each of the first `n_keep` compacted
    triples (row, key', payload) of `planes` (int32[3, N]), the state row
    `state[row]` (int64[rows, W]) with column `level` set to key = key' +
    kmin - 1, then (key, payload) when `full`, else (0, key). A level with
    no match launches nothing."""
    n_keep, kmin = int(n_keep), int(kmin)
    _check(planes, n_keep, kmin, state, level)
    if planes.device.type == "cpu":
        return emit_rows_plain(planes, n_keep, kmin, state, level, full)
    width = state.shape[1]
    out = state.new_empty((n_keep, width + 2))
    if not n_keep:
        return out
    # kmin - 1 as the int64 of its bits: the kernel adds it wrapping
    key_off = (kmin - 1 - I64_MIN) % 2**64 + I64_MIN
    code = _build.load().ccve_emit_rows_i32(
        planes.data_ptr(), planes.shape[1], n_keep, key_off, state.data_ptr(), width, level,
        int(bool(full)), out.data_ptr(), _build.stream(planes),
    )
    _build.check(code, "emit_rows_i32")
    emit_rows_i32.launches += 1
    return out


emit_rows_i32.launches = 0
