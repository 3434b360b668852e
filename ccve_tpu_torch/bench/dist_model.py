"""Cost model of the distributed shuffles on H100 GPUs.

Port of `ccve_tpu.bench.dist_model`. One H100 cannot measure a multi-GPU
speed, so this model states what can be stated exactly, the bytes each
plan moves a level and across which link, and prices them with published
nominal link rates of an H100 node. It prices the plans of
`parallel/distributed.py`:

  flat  (`dist_bulk_count`): a level is one all-to-all of the [P, cap]
        int64 key grid and two back (int32 mult, int64 psum). On a
        multi-node mesh every GPU pair talks directly, so (P - I) of a
        GPU's P grid rows leave its node, one message each.
  hier  (`dist_bulk_count_hier`): hop A inside the node ([I, capA]), hop
        B across nodes ([D, capB], every row live), (mult, psum) back
        through both.
  bcast (`dist_bulk_count_bcast`): a one-time copy of the build table to
        every GPU, then an all-reduce of L + 1 scalars a probe batch.

The byte counts follow the grids and equal the JAX model's for every
topology (tests/test_torch_dist_model.py holds them to it). The link
constants are the H100 platform's, nominal, none measured:

  NVLINK_BW   450e9 B/s a direction a GPU: NVLink 4 on the H100 SXM5, 900
              GB/s in total over 18 links (NVIDIA's H100 data sheet)
  IB_GPU_BW   50e9 B/s a GPU: one ConnectX-7 NDR 400 Gb/s port a GPU, as
              in a DGX H100 (8 a node); a node sends I x that
  IB_MSG_S    5e-6 s a message that leaves the node: an assumption (an RDMA
              message's set-up and latency), not a data-sheet figure

Inside a node every GPU reaches every other through NVSwitch at its own
NVLink rate, so an all-to-all is no ring: a GPU sends the (P - 1) / P of
its B bytes that leave it at W, t = B (P - 1) / (P W) (the TPU model's
ring time B P / (8 W) does not apply). Across nodes the model takes full
bisection at each node's NICs: t = bytes leaving the node / (I x
IB_GPU_BW). Predictions at 2 x 8 and 4 x 8 GPUs have a DGX H100's shape.

Compute a GPU reuses the single-GPU roofline (`bench.roofline.
count_side_model`) at the GPU's share, n / P probe rows against the m / P
rows of its partition: the distributed probe is the single-device engine
on the received grid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ccve_tpu_torch.bench.roofline import count_side_model

NVLINK_BW = 450e9  # B/s a direction a GPU, H100 SXM5 NVLink 4 (nominal)
IB_GPU_BW = 50e9  # B/s a GPU, one ConnectX-7 NDR 400 Gb/s port (nominal)
IB_MSG_S = 5e-6  # s a message that leaves the node (assumed)

I64 = 8
I32 = 4


def t_a2a(bytes_per_dev: float, p: int, w_link: float = NVLINK_BW) -> float:
    """All-to-all time through NVSwitch of `p` GPUs, each with
    `bytes_per_dev` to spread evenly: the (p - 1) / p that leave a GPU at its
    link rate. p == 1 is free."""
    if p <= 1:
        return 0.0
    return bytes_per_dev * (p - 1) / (p * w_link)


def _cap(per_dev: int, n_parts: int, slack: float = 2.0) -> int:
    # dist_bulk_count's cap: per_dev / P * slack + 8, at least 16, at most per_dev
    return min(max(int(per_dev / n_parts * slack) + 8, 16), per_dev)


def _node_bw(n_ici: int) -> float:
    return IB_GPU_BW * n_ici


@dataclass
class ShuffleCost:
    name: str
    t_ici: float  # seconds inside the node a level
    t_dcn: float  # seconds across nodes a level
    bytes_ici: float  # bytes a GPU sends a level (grid bytes)
    bytes_dcn: float  # bytes a node sends to other nodes a level

    @property
    def t_level(self) -> float:
        # a level's hops run one after another (route, probe, route back)
        return self.t_ici + self.t_dcn


def flat_shuffle_cost(n_probe: int, n_hosts: int, n_ici: int, slack: float = 2.0) -> ShuffleCost:
    """A level of the flat shuffle on D nodes x I GPUs: forward [P, cap]
    int64, back [P, cap] int32 + [P, cap] int64. Row r of a GPU's grid goes
    to GPU r; (P - I) rows leave the node."""
    p = n_hosts * n_ici
    per_dev = -(-n_probe // p)
    cap = _cap(per_dev, p, slack)
    total = p * cap * (I64 + I32 + I64)
    if n_hosts == 1:
        return ShuffleCost("flat", t_a2a(total, p), 0.0, total, 0.0)
    # the share (P - I) / P of every grid leaves the node GPU pair by GPU pair;
    # a node sends I GPUs' worth, each GPU (P - I) messages an all-to-all
    # (3 a level: keys out, mult and psum back)
    off_frac = (p - n_ici) / p
    dcn_per_host = total * off_frac * n_ici
    ici_bytes = total * (1 - off_frac)
    t_msg = 3 * (p - n_ici) * IB_MSG_S
    return ShuffleCost("flat", t_a2a(ici_bytes, n_ici),
                       dcn_per_host / _node_bw(n_ici) + t_msg, ici_bytes, dcn_per_host)


def hier_shuffle_cost(n_probe: int, n_hosts: int, n_ici: int, slack: float = 2.0) -> ShuffleCost:
    """A level of the two-hop shuffle: hop A inside the node ([I, capA]
    int64, capA = 2 per_dev / I + 8), hop B across nodes once ([D, capB],
    capB = 2 per_dev / D + 8, every row live), (mult int32, psum int64)
    back through B, then A."""
    d, i = n_hosts, n_ici
    per_dev = -(-n_probe // (d * i))

    def capf(avg):
        return max(int(avg * slack) + 8, 16)

    cap_a, cap_b = capf(per_dev / i), capf(per_dev / max(d, 1))
    fwd_a = i * cap_a * I64
    back = (I32 + I64) / I64  # back per forward byte: 12 B a slot for 8
    bytes_ici = fwd_a * (1 + back)
    t_ici = t_a2a(fwd_a, i) + t_a2a(fwd_a * back, i)
    # hop B: (d - 1) of a GPU's d rows leave the node, I GPUs a node, each
    # GPU (d - 1) messages an all-to-all (3 a level)
    dcn_per_host = (d - 1) * cap_b * (I64 + I32 + I64) * i
    t_dcn = dcn_per_host / _node_bw(i) + 3 * (d - 1) * IB_MSG_S if d > 1 else 0.0
    return ShuffleCost("hier", t_ici, t_dcn, bytes_ici, dcn_per_host)


def bcast_cost(n_build: int, n_hosts: int, n_ici: int,
               table_bytes_per_row: int = 2 * I64) -> ShuffleCost:
    """One-time cost of a level's build table on every GPU
    (`replicate_tables`), priced as an all-gather of its b = 16 m bytes:
    inside a node each GPU receives (I - 1) / I of it over NVLink; across
    nodes each node receives the (D - 1) / D it lacks over its I NICs, with
    D - 1 messages. The bytes are the JAX model's: b inside a node, b (D -
    1) across nodes in all. Unlike the shuffles this cost does not recur a
    probe batch: `predict` divides it over `n_batches`."""
    b = n_build * table_bytes_per_row
    t_ici = t_a2a(b, n_ici)
    if n_hosts == 1:
        return ShuffleCost("bcast", t_ici, 0.0, b, 0.0)
    dcn = b * (n_hosts - 1)
    t_dcn = dcn / n_hosts / _node_bw(n_ici) + (n_hosts - 1) * IB_MSG_S
    return ShuffleCost("bcast", t_ici, t_dcn, b, dcn)


@dataclass
class DistPrediction:
    n_hosts: int
    n_ici: int
    shuffle: str
    t_compute: float
    t_comm: float
    t_total: float
    rows_per_s: float
    efficiency: float  # against P x the single-GPU rate


def predict(n_build: int, n_probe: int, n_levels: int = 1,
            topologies=((1, 4), (1, 8), (2, 8), (4, 8), (8, 8)), shuffle: str = "auto",
            n_batches: int = 1) -> list[DistPrediction]:
    """Predicted rate and scaling of config-1/5-shaped joins. Compute a GPU
    = the single-GPU roofline at (m / P builds, n / P probes) a level (the
    whole build for bcast). Communication = the plan's cost a level;
    "auto" picks hier when there is more than one node, as
    `bootstrap.run_dist_join` does. For "bcast" the table copy is divided
    over `n_batches` probe batches streamed against one build (the
    reference streams its whole probe side against one build,
    main.cpp:62-95), and each batch pays one all-reduce of scalars (log2 D
    rounds across nodes)."""
    t1 = sum(op.t_sol for op in count_side_model(n_build, n_probe)) * n_levels
    out = []
    for d, i in topologies:
        p = d * i
        kind = shuffle if shuffle != "auto" else ("hier" if d > 1 else "flat")
        local_build = n_build if kind == "bcast" else max(n_build // p, 1)
        t_comp = sum(op.t_sol for op in count_side_model(local_build, max(n_probe // p, 1))) \
            * n_levels
        if kind == "bcast":
            sc = bcast_cost(n_build, d, i)
            t_psum = math.ceil(math.log2(d)) * IB_MSG_S if d > 1 else 0.0
            t_comm = sc.t_level * n_levels / max(n_batches, 1) + t_psum
        else:
            cost_fn = hier_shuffle_cost if kind == "hier" else flat_shuffle_cost
            t_comm = cost_fn(n_probe, d, i).t_level * n_levels
        t_total = t_comp + t_comm
        out.append(DistPrediction(n_hosts=d, n_ici=i, shuffle=kind, t_compute=t_comp,
                                  t_comm=t_comm, t_total=t_total, rows_per_s=n_probe / t_total,
                                  efficiency=t1 / (p * t_total)))
    return out


def ranking(n_build: int, n_probe: int, n_hosts: int, n_ici: int, n_levels: int = 1,
            n_batches: int = 1) -> list[str]:
    """The plans flat, hier and bcast at one topology, fastest first by the
    model's t_total."""
    preds = {s: predict(n_build, n_probe, n_levels, ((n_hosts, n_ici),), s, n_batches)[0]
             for s in ("flat", "hier", "bcast")}
    return sorted(preds, key=lambda s: preds[s].t_total)


def report_dist(n_build: int = 1_000_000, n_probe: int = 16_000_000, n_levels: int = 1) -> str:
    preds = predict(n_build, n_probe, n_levels)
    groups = []
    for pr in preds:
        if pr.n_hosts > 1:  # flat, hier and the amortized bcast across nodes
            groups.extend(predict(n_build, n_probe, n_levels, ((pr.n_hosts, pr.n_ici),), s,
                                  8 if s == "bcast" else 1)
                          for s in ("flat", "hier", "bcast"))
        else:
            groups.append([pr])
    lines = [
        f"distributed shuffle cost model @ {n_build / 1e6:.1f}M build / "
        f"{n_probe / 1e6:.1f}M probe x {n_levels} level(s)",
        f"(NVLink {NVLINK_BW / 1e9:.0f} GB/s a GPU a direction through NVSwitch, InfiniBand "
        f"{IB_GPU_BW / 1e9:.0f} GB/s a GPU, {IB_MSG_S * 1e6:.0f} us a message (assumed); "
        f"byte counts exact per distributed.py's grids, link rates nominal, none measured)",
        f"{'mesh':>9s} {'shuffle':>7s} {'t_comp':>9s} {'t_comm':>9s} "
        f"{'t_total':>9s} {'rows/s':>9s} {'eff':>6s}",
    ]
    for group in groups:
        for pr in group:
            lines.append(
                f"{pr.n_hosts:>4d}x{pr.n_ici:<4d} {pr.shuffle:>7s} "
                f"{pr.t_compute * 1e3:7.3f}ms {pr.t_comm * 1e3:7.3f}ms "
                f"{pr.t_total * 1e3:7.3f}ms {pr.rows_per_s / 1e6:7.1f}M {pr.efficiency:6.2f}")
    lines.append(
        "eff = predicted P-GPU rate / (P x the single-GPU roofline); bcast's table copy is "
        "amortized over 8 probe batches. Across nodes the per-key shuffles pay ~20 B a key a "
        "level on InfiniBand while compute and bytes both shrink with P; bcast replaces them "
        "with a one-time copy of 16 B a build row and an all-reduce of L + 1 scalars, as long "
        "as the build fits in a GPU's memory.")
    return "\n".join(lines)


if __name__ == "__main__":
    print(report_dist())
