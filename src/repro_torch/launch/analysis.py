"""Roofline terms of one dry-run cell, on the H100's datasheet rates
(PyTorch counterpart of ``repro.launch.analysis``).

Three terms per cell, in seconds, per device:

  compute    = FLOPs / peak bf16 FLOP/s
  memory     = HBM bytes / HBM bandwidth
  collective = sum over collectives of operand_bytes * ring_factor
               / (NVLink bandwidth when the op's group lies within one
                  node, else the network's)

The FLOPs and bytes come from ``launch/op_cost.py`` (the port runs eager:
it counts the aten ops a step dispatches, where the JAX package reads
XLA's HLO), the collectives from ``launch/mesh.py::ShapeMesh``.  Ring
factors as the JAX module's: all-reduce 2(g-1)/g, all-gather,
reduce-scatter and all-to-all (g-1)/g, collective-permute 1.

The rates are NVIDIA's published figures, not measurements; they hold at
the card's full 700 W power limit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-device rates of the roofline (bytes and FLOPs per second)."""
    peak_flops: float        # dense bf16
    hbm_bw: float
    intra_node_bw: float     # per device, one direction, inside a node
    inter_node_bw: float     # per device, one direction, between nodes
    devices_per_node: int


#: NVIDIA H100 SXM5 80GB at 700 W: 989 TFLOP/s dense bf16 and 3.35 TB/s
#: HBM3 (H100 datasheet); NVLink 4, 900 GB/s a GPU both ways, so 450 GB/s
#: each way, to the other 7 GPUs of an HGX/DGX H100 node (H100
#: datasheet); between nodes one ConnectX-7 NDR 400 Gb/s port a GPU, 50
#: GB/s each way (DGX H100 datasheet).
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, intra_node_bw=450e9,
                inter_node_bw=50e9, devices_per_node=8)


@dataclasses.dataclass
class CollectiveOp:
    """One collective a rank ran: its operand bytes (what it handed to
    the collective, as ``Mesh.sent_bytes`` counts them), the size of its
    group and whether that group spans more than one node."""
    kind: str
    operand_bytes: int
    group_size: int
    crosses_node: bool = False

    @property
    def ring_factor(self) -> float:
        g = max(self.group_size, 1)
        if self.kind == "all-reduce":
            return 2.0 * (g - 1) / g
        if self.kind == "collective-permute":
            return 1.0
        return (g - 1) / g

    @property
    def wire_bytes(self) -> float:
        return self.operand_bytes * self.ring_factor


def collective_summary(ops: List[CollectiveOp]
                       ) -> Dict[str, Dict[str, float]]:
    """Per kind: count, operand bytes and wire bytes."""
    summ: Dict[str, Dict[str, float]] = {}
    for op in ops:
        d = summ.setdefault(op.kind, {"count": 0, "operand_bytes": 0.0,
                                      "wire_bytes": 0.0})
        d["count"] += 1
        d["operand_bytes"] += op.operand_bytes
        d["wire_bytes"] += op.wire_bytes
    return summ


def roofline_terms(cost: Optional[dict], ops: List[CollectiveOp],
                   model_flops_per_device: float = 0.0,
                   hw: Hardware = H100) -> Dict[str, float]:
    """The JAX module's record, on ``hw``: ``cost`` holds "flops" and
    "bytes accessed" per device."""
    cost = cost or {}
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    wire = sum(op.wire_bytes for op in ops)
    t_compute = flops / hw.peak_flops
    t_memory = bytes_acc / hw.hbm_bw
    by_rate: Dict[float, float] = {}    # link rate -> wire bytes over it
    for op in ops:
        rate = hw.inter_node_bw if op.crosses_node else hw.intra_node_bw
        by_rate[rate] = by_rate.get(rate, 0.0) + op.wire_bytes
    t_coll = sum(w / rate for rate, w in by_rate.items())
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", t_coll)), key=lambda kv: kv[1])[0]
    out = {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "collective_wire_bytes_per_device": wire,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dom,
        "bound_step_time_s": max(t_compute, t_memory, t_coll),
    }
    if model_flops_per_device:
        out["model_flops_per_device"] = model_flops_per_device
        out["useful_compute_ratio"] = (
            model_flops_per_device / flops if flops else 0.0)
        peak_time = model_flops_per_device / hw.peak_flops
        out["roofline_fraction"] = (
            peak_time / out["bound_step_time_s"]
            if out["bound_step_time_s"] else 0.0)
    return out
