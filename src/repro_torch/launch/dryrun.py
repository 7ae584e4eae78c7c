"""Dry run: what every (arch x shape x mesh) cell and every TCQ cell costs
one device of the production mesh, on the H100's roofline (PyTorch
counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun [--arch all|a,b] [--shape all|s,t]
        [--mesh single|multi|both] [--smoke] [--tcq all|name,...]
        [--combine psum,rs_ag] [--out build/dryrun]

The JAX package lowers each cell on 512 fake devices and reads XLA's HLO.
The port runs each cell's step eagerly, as rank 0 of the (16, 16) or
(2, 16, 16) layout (``--mesh single`` / ``multi``), on ``meta`` tensors
(shapes and dtypes, no storage, nothing computed) over a
``launch.mesh.ShapeMesh``, whose collectives record their bytes and move
nothing; ``launch/op_cost.py`` counts the FLOPs, the HBM bytes, each
hand-written kernel's charge and the collectives as the step runs, and
``launch/analysis.py`` turns them into the roofline terms.  The steps are
the port's own entry points, so the cost is that of the code that runs on
the card:

* LM cells: ``param_template``'s leaves on ``meta``, cut to the rank's
  blocks by ``Transformer(cfg, params=, mesh=)``; the batch and cache of
  ``launch/shapes.py``; then ``build_train_step`` (with ``microbatches``,
  remat and the optimizer's update), ``prefill_step`` or ``serve_step``.
  A decode step's ``cache_index`` is a host integer (the last position),
  where JAX traces it: the step reads it on the host to place the token.
* TCQ cells: ``abstract_sharded_tel`` and one iteration of
  ``build_wave_step(single_iteration=True)``, the roofline unit, for every
  ``get_tcq_config`` name, mesh and combine.

Each cell's record has the JAX dry run's fields.  ``lower_s`` is the time
to build the cell's model and inputs, ``compile_s`` the time of the meta
step (the port compiles nothing); ``roofline.hlo_*`` are the counted
FLOPs and bytes (``FlopCounterMode``'s total is also
``flop_counter_flops``).  Records go under ``build/dryrun/`` (one JSON
file per cell, reused unless ``--smoke``); the last line is ``[dryrun]
done: N ok, M skipped (recorded), F failed``.  The terms are a model on
datasheet rates, not a measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (get_config, get_smoke_config,
                                 get_tcq_config, list_archs,
                                 list_tcq_configs)
from repro_torch.launch import analysis
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import AXES, AXES_MULTI_POD, ShapeMesh
from repro_torch.launch.op_cost import OpCost, tensor_bytes

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def production_mesh(multi_pod: bool, rank: int = 0) -> ShapeMesh:
    """Rank ``rank`` of the (16, 16) or (2, 16, 16) production layout."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), AXES_MULTI_POD, rank=rank)
    return ShapeMesh((16, 16), AXES, rank=rank)


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _leaves(tree) -> list:
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def lm_cost(cfg, cell: S.ShapeCell, mesh: ShapeMesh, n_micro=None):
    """Run one LM cell's step on ``meta`` tensors as ``mesh``'s rank:
    (OpCost of the step, {"argument_bytes": the rank's parameters,
    optimizer state, batch and cache}, build seconds, step seconds)."""
    from repro_torch.launch.steps import (build_train_step, prefill_step,
                                          serve_step)
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    dt = T._dtype(cfg)
    params = T._map(lambda p: torch.empty(p.shape, dtype=dt, device="meta"),
                    T.param_template(cfg))
    model = T.Transformer(cfg, params=params, mesh=mesh)
    del params
    batch, _ = S.batch_specs(cfg, cell, mesh)
    args = _leaves(model.params.tree()) + list(batch.values())
    if cell.kind == "train":
        if n_micro is None:
            n_micro = S.microbatches(cfg, cell, mesh)
        step, opt = build_train_step(cfg, n_micro)
        state = opt.init(model.params.tree(), mesh=mesh,
                         pspecs=model.pspecs)
        args += _leaves(state)
        run = lambda: step(model, state, batch)          # noqa: E731
    else:
        cache = T.init_cache(cfg, cell.batch, cell.seq,
                             s_enc=cell.seq if cfg.encoder_layers else None,
                             mesh=mesh)
        args += _leaves(cache)
        if cell.kind == "prefill":
            run = lambda: prefill_step(model, batch, cache)  # noqa: E731
        else:
            batch["cache_index"] = cell.seq - 1
            run = lambda: serve_step(model, cache, batch)    # noqa: E731
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    with OpCost(mesh) as cost:
        run()
    return cost, {"argument_bytes": tensor_bytes(
        *[a for a in args if isinstance(a, torch.Tensor)])}, built, \
        time.perf_counter() - t0


def _cost_record(cost: OpCost, mf_per_device: float = 0.0,
                 hw: analysis.Hardware = analysis.H100) -> dict:
    terms = analysis.roofline_terms(
        {"flops": cost.flops, "bytes accessed": cost.bytes},
        cost.collectives, model_flops_per_device=mf_per_device, hw=hw)
    terms["flop_counter_flops"] = float(cost.flops)
    terms["kernels"] = {k: dict(v) for k, v in cost.kernels.items()}
    terms["top_ops"] = cost.top_ops()
    return terms


def lower_cell(arch: str, shape: str, multi_pod: bool, smoke: bool = False,
               overrides: dict = None, rank: int = 0):
    """One LM cell's record as rank ``rank`` of the production mesh (the
    JAX ``lower_cell``'s fields).  ``overrides``: ModelConfig fields."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    cell = S.SHAPES[shape]
    if smoke:
        cell = S.ShapeCell(cell.name, min(cell.seq, 128),
                           min(cell.batch, 8), cell.kind)
    ok, why = S.cell_is_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "skipped": True,
                "reason": why}
    mesh = production_mesh(multi_pod, rank)
    cost, mem, t_build, t_run = lm_cost(cfg, cell, mesh)
    tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
    # 6·N·D, as the JAX record: inference cells show a ratio near 3
    mf = cfg.model_flops(tokens)
    return {
        "arch": arch, "shape": shape, "mesh": _mesh_name(mesh),
        "chips": mesh.size, "rank": mesh.rank, "smoke": smoke,
        "kind": cell.kind, "seq": cell.seq, "batch": cell.batch,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "optimizer": cfg.optimizer,
        "lower_s": round(t_build, 2), "compile_s": round(t_run, 2),
        "memory": {**mem, "output_bytes": None, "temp_bytes": None,
                   "generated_code_bytes": None},
        "collectives": analysis.collective_summary(cost.collectives),
        "sent_bytes": cost.sent_bytes,
        "layout_bytes": cost.layout_bytes,
        "control": analysis.collective_summary(cost.control),
        "hardware": dataclasses.asdict(analysis.H100),
        "roofline": _cost_record(cost, mf / mesh.size),
    }


def meta_tel(tel):
    """A ``ShardedTEL`` of ``meta`` tensors shaped as ``tel`` (a
    ``ShardPlan`` or a ``ShardedTEL``): the dry run's twin of a live
    plan."""
    from repro_torch.core.distributed import ShardedTEL

    def meta(a):
        return torch.empty(tuple(a.shape), dtype=torch.int32, device="meta")

    return ShardedTEL(meta(tel.src), meta(tel.dst), meta(tel.t),
                      meta(tel.pair_local), meta(tel.hp_src),
                      meta(tel.hp_pair), int(tel.num_vertices),
                      int(tel.num_pairs_shard), int(tel.num_shards))


def tcq_cost(tel, wave: int, mesh: ShapeMesh, combine: str):
    """One single-iteration TCQ step over the ``meta`` sharded TEL ``tel``
    with ``wave`` lanes, as ``mesh``'s rank: (OpCost, build seconds, step
    seconds)."""
    from repro_torch.core import distributed as D

    t0 = time.perf_counter()
    step = D.build_wave_step(mesh, num_vertices=tel.num_vertices,
                             combine=combine, p_s=tel.num_pairs_shard,
                             single_iteration=True)
    mi = mesh.model_index
    shard = [a[mi] for a in (tel.src, tel.dst, tel.t, tel.pair_local,
                             tel.hp_src, tel.hp_pair)]

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    alive = meta(wave, tel.num_vertices, dtype=torch.bool)
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    with OpCost(mesh) as cost:
        step(*shard, alive, meta(wave), meta(wave), meta(), meta())
    return cost, built, time.perf_counter() - t0


def lower_tcq_cell(name: str, multi_pod: bool, combine: str = "rs_ag",
                   wave: int = None, rank: int = 0) -> dict:
    """One distributed-TCQ cell's record (a single peel iteration, the
    roofline unit), with the JAX record's useful bytes."""
    cfg = get_tcq_config(name)
    if wave:
        cfg = dataclasses.replace(cfg, wave=wave)
    from repro_torch.core.distributed import abstract_sharded_tel

    mesh = production_mesh(multi_pod, rank)
    m = mesh.model_shards
    tel = abstract_sharded_tel(cfg.num_vertices, cfg.num_edges,
                               cfg.num_pairs, m)
    cost, t_build, t_run = tcq_cost(tel, cfg.wave, mesh, combine)
    e_s = tel.src.shape[1]
    p_s = tel.num_pairs_shard
    q = cfg.wave
    q_loc = max(1, q // (mesh.size // m))
    v = tel.num_vertices
    # intrinsic per-iteration streaming of the algorithm (per device),
    # the JAX dry run's formula
    useful = (e_s * 16                      # edge arrays read once
              + 2 * q_loc * e_s * 1        # edge-activity bools r/w
              + 2 * p_s * q_loc * 4        # pair counts w+r
              + 2 * 2 * p_s * q_loc * 4    # half-pair contributions
              + v * q_loc * 4)             # degree write
    terms = _cost_record(cost)
    terms["useful_bytes_per_device"] = useful
    terms["min_traffic_fraction"] = (
        useful / analysis.H100.hbm_bw / terms["bound_step_time_s"]
        if terms["bound_step_time_s"] else 0.0)
    return {
        "arch": name, "shape": f"wave{q}", "kind": "tcq",
        "mesh": _mesh_name(mesh), "chips": mesh.size, "rank": mesh.rank,
        "combine": combine, "V": cfg.num_vertices, "E": cfg.num_edges,
        "P": cfg.num_pairs,
        "lower_s": round(t_build, 2), "compile_s": round(t_run, 2),
        "memory": {"temp_bytes": None, "argument_bytes": tensor_bytes(
            tel.src[0], tel.dst[0], tel.t[0], tel.pair_local[0],
            tel.hp_src[0], tel.hp_pair[0]) + q * v},
        "collectives": analysis.collective_summary(cost.collectives),
        "sent_bytes": cost.sent_bytes,
        "control": analysis.collective_summary(cost.control),
        "hardware": dataclasses.asdict(analysis.H100),
        "roofline": terms,
    }


def _run(tag: str, path: Path, make, write: bool) -> dict:
    """One cell: reuse its record when written, else make it (a failure
    is recorded with its traceback)."""
    if write and path.exists():
        print(f"[dryrun] cached {tag}")
        return json.loads(path.read_text())
    print(f"[dryrun] {tag} ...", flush=True)
    try:
        rec = make()
    except Exception:
        rec = {"tag": tag, "failed": True,
               "error": traceback.format_exc()[-2000:]}
    if write:
        path.write_text(json.dumps(rec, indent=1))
    status = ("SKIP" if rec.get("skipped") else
              "FAIL" if rec.get("failed") else
              f"ok ({rec['compile_s']}s meta step, "
              f"dom={rec['roofline']['dominant']})")
    print(f"[dryrun] {tag}: {status}", flush=True)
    return rec


def run_cells(archs, shapes, meshes, smoke=False, out_dir=RESULTS_DIR):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                multi = mesh_name == "multi"
                tag = f"{arch}__{shape}__{'2x16x16' if multi else '16x16'}"
                results.append(_run(
                    tag, out_dir / f"{tag}.json",
                    lambda: lower_cell(arch, shape, multi, smoke),
                    not smoke))
    return results


def run_tcq_cells(names, meshes, combines=("psum", "rs_ag"),
                  out_dir=RESULTS_DIR):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for name in names:
        for mesh_name in meshes:
            for combine in combines:
                multi = mesh_name == "multi"
                tag = (f"{name}__wave__{'2x16x16' if multi else '16x16'}"
                       f"__{combine}")
                results.append(_run(
                    tag, out_dir / f"{tag}.json",
                    lambda: lower_tcq_cell(name, multi, combine), True))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI self-test)")
    ap.add_argument("--tcq", default="",
                    help="TCQ engine configs ('all' or comma list); "
                         "replaces the LM sweep when set")
    ap.add_argument("--combine", default="psum,rs_ag")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    if args.tcq:
        names = (list_tcq_configs() if args.tcq == "all"
                 else args.tcq.split(","))
        results = run_tcq_cells(names, meshes,
                                combines=tuple(args.combine.split(",")),
                                out_dir=args.out)
    else:
        archs = list_archs() if args.arch == "all" else args.arch.split(",")
        shapes = (list(S.SHAPES) if args.shape == "all"
                  else args.shape.split(","))
        results = run_cells(archs, shapes, meshes, smoke=args.smoke,
                            out_dir=args.out)
    n_ok = sum(1 for r in results if not r.get("failed")
               and not r.get("skipped"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    n_fail = sum(1 for r in results if r.get("failed"))
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped (recorded), "
          f"{n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
