"""Tiny cells for the CPU tests: the real cells' drivers and parameters at
a size a test run holds."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

CONFIG = {"name": "tiny", "graph": {"num_vertices": 800, "num_edges": 20_000,
                                    "time_span": 300, "burst_periods": 14,
                                    "seed": 11}}

PARAMS = {
    "batch": {"requests": {"kind": "stratified", "per_batch": 8, "k": 4,
                           "h": 1, "span": 20},
              "warmup_batches": 1, "check_queries": 6},
    "shifted": {"requests": {"kind": "shifted", "h": 1, "shift_div": 32,
                             "shift_seed": 11,
                             "windows": [[4, 10, 40], [5, 100, 140],
                                         [3, 200, 230]]},
                "warmup_batches": 1, "warmup_per_batch": 1,
                "check_queries": 4},
}

DRIVER = {"batch": "batch", "shifted": "batch"}
CELL = {"batch": "sx-mathoverflow.batch", "shifted": "tcq-youtube.batch"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(kind: str) -> dict:
    return {"name": CELL[kind], "config": "tiny", "driver": DRIVER[kind],
            "params": PARAMS[kind]}


def run(kind: str, seed: int = 2**31 + 77, seconds: float = 1.0):
    """One tiny run of the cell through ``run.run_cell`` on the CPU."""
    from tcqbench import run as runmod

    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == CELL[kind])
    return runmod.run_cell(b, entry, workload(kind), CONFIG, seed, seconds,
                           False, "cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """Runs of the harness on one CPU thread each: the suite runs in
    several worker processes, and more threads only contend."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
