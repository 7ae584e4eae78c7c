#!/usr/bin/env python3
"""Run one cell of the benchmark once:

    python3 tcqbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``;
its parameters are ``tcqbench/workloads/<cell>.json``, which names its
configuration (``tcqbench/configs/<config>.json``) and its traffic driver
(``tcqbench/traffic/<driver>.py``).  Per-layer metrics are read by
``tcqbench/metrics/<metric>.py``.  Set-up (graph, engine, warm-up) is timed from the start of this script to the start of the
window; the window runs for ``--seconds``; then the program's state is
freed and the reference checks a seeded sample of its answers.

The last line of standard output is the result, as one JSON object; the
last lines of standard error are the numbers compared, each with its
limit.  ``--trace 1`` runs the window under ``torch.profiler`` and reports
the per-layer metrics in place of the end-to-end ones.  The run fails,
and prints no result, without a CUDA card, without the program
(``src/repro_torch``), or when JAX or the JAX package was loaded.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = ROOT / "build" / "tcqbench"
HOST_THREADS = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path):
    """Import a file of the benchmark by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "tcqbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str):
    """(benchmark, workload entry, cell file, configuration file)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    config = json.loads(
        (HERE / "configs" / f"{entry['config']}.json").read_text())
    return bench, entry, workload, config


def metrics_of(bench: dict, name: str, kind: str) -> list:
    """The cell's entries of ``end_to_end`` or ``per_layer``."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def loaded_forbidden(modules=None) -> list:
    """Top-level names of JAX or the JAX package among the loaded modules
    (``sys.modules`` by default), each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip() or "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def run_cell(bench: dict, entry: dict, workload: dict, config: dict,
             seed: int, seconds: float, trace: bool, device,
             t_start: float = None) -> dict:
    """Run the cell once on ``device`` and return the result object (the
    CLI's checks for a card and for JAX are left to ``main``)."""
    import torch

    from tcqbench import check as chk
    from tcqbench.trace import SOURCE, Spans, capture, reduce

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = load_module(HERE / "traffic" / f"{workload['driver']}.py")
    drv = driver.Driver(workload, config, seed, device)
    spans = Spans()
    log(f"info before_setup_s {time.perf_counter() - t_start!r}")
    drv.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    tr = None
    if trace:
        e2e, events, t0, t1 = capture(lambda: drv.window(seconds, spans))
        tr = reduce(events, t0, t1, spans.items)
    else:
        e2e = drv.window(seconds, spans)
        sync()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    rec = {"window_s": drv.window_s, "spans": spans, "trace": tr,
           **drv.record()}
    name = entry["name"]
    metrics = {}
    if trace:
        for m in metrics_of(bench, name, "per_layer"):
            val = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in metrics_of(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    for k, v in drv.info().items():
        log(f"info {k} {v}")
    for k, v in e2e.items():
        log(f"e2e {k} {v!r}")
    failed = drv.failed()
    attempted = drv.attempted
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = drv.check()
    log(f"info reference_s {time.perf_counter() - t_ref!r}")
    dev = {"platform": "gpu" if cuda else str(device),
           "kind": torch.cuda.get_device_name(0) if cuda else str(device),
           "count": int(entry["chips"]) if cuda else 1,
           "memory_peak_bytes": peak}
    out = {"correct": chk.verdict(checks), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
        out["trace"] = {"source": SOURCE, "events": tr["events"],
                        "power": power_limit() if cuda else "not measured",
                        "idle_by_span": tr["idle_by_span"]}
        log(f"trace {json.dumps(out['trace'])}")
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # few host threads: the run shares its host's cores, and the host's
    # work is the program's numpy and small torch operations
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    # every cache of the run lives at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    bench, entry, workload, config = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        log(f"needs {entry['chips']} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        log(f"the program (src/repro_torch) is not in this checkout: {exc}")
        return 3
    out = run_cell(bench, entry, workload, config, args.seed, args.seconds,
                   bool(args.trace), "cuda", t_start=_T_START)
    bad = loaded_forbidden()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 4
    from tcqbench.check import lines

    for line in lines(out["checks"]):
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
