"""The trace reader's arithmetic on hand-made traces."""

import pytest

from benchmark import trace

OWN = "void (anonymous namespace)::sort_tiles_kernel<int, 16>(int const*, int*, long long)"
TORCH = "void at::native::reduce_kernel<512>()"
COPY = "Memcpy DtoH (Device -> Pageable)"


def _query(t, entry_us, read_us, tail_us=1.0):
    """Host spans of one query starting at t: (spans, its end)."""
    e0, e1 = t + 1, t + 1 + entry_us
    r0, r1 = e1 + 2, e1 + 2 + read_us
    end = r1 + tail_us
    return [(trace.QUERY, t, end), (trace.ENTRY, e0, e1), (trace.READ, r0, r1)], end


def test_kernel_names_sort_by_the_frozen_rule():
    assert trace.is_own_kernel(OWN)
    for name in ("void at::native::vectorized_elementwise_kernel<4, at::native::Fill>()",
                 "void at_cuda_detail::cub::DeviceScanKernel<int>()", COPY,
                 "Memset (Device)"):
        assert not trace.is_own_kernel(name)


def test_reduce_reads_busy_kernels_and_copies():
    device = []
    for q in (0.0, 100.0, 200.0):  # three queries: a kernel of each kind, a copy
        device += [(OWN, q + 3, q + 9), (TORCH, q + 8, q + 11), (COPY, q + 14, q + 16),
                   (trace.ENTRY, q + 3, q + 11)]  # a span on the device's timeline
    r = trace.reduce(device, 3, 300e-6, [["x", 1.0]])
    assert r.queries == 3 and r.ops == 9 and r.window_s == 300e-6
    assert r.own_s == pytest.approx(3 * 6e-6) and r.other_s == pytest.approx(3 * 5e-6)
    assert r.busy_s == pytest.approx(3 * 10e-6)  # 3-11 and 14-16: overlaps count once
    assert [n for n, _ in r.device_ops] == [OWN[: trace.NAME_CHARS], TORCH, COPY]
    assert r.idle_gaps == [["x", 1.0]]


def test_idle_gaps_name_the_host_span_and_op():
    host, t, starts = [], 0.0, []
    for _ in range(trace.SKIP + 3):
        spans, end = _query(t, entry_us=10, read_us=4)
        host += spans
        starts.append(t)
        t = end + 5  # the harness between queries
    device = []
    for q in starts:
        device += [(OWN, q + 3, q + 11), (COPY, q + 14, q + 16), (trace.ENTRY, q, q + 30)]
    host.append(("aten::cat", starts[-1] + 13, starts[-1] + 14))
    host.append(("aten::sub", starts[-1] + 1, starts[-1] + 3))
    idle = dict(trace.idle_gaps(device, host))
    first, last = starts[trace.SKIP], starts[-1]
    window = (last + 1 + 10 + 2 + 4 + 1) - first
    busy = 3 * 10
    assert sum(idle.values()) == pytest.approx((window - busy) * 1e-6)
    assert idle["harness/python"] == pytest.approx(2 * 5e-6)
    assert idle["answer_read/aten::cat"] == pytest.approx(1e-6, abs=1e-7)
    assert idle["entry/aten::sub"] == pytest.approx(2e-6, abs=1e-7)


def test_idle_gaps_refuse_unpaired_spans():
    spans, _ = _query(0.0, 3, 3)
    with pytest.raises(ValueError):
        trace.idle_gaps([], spans[:2] * (trace.SKIP + 1))
