"""Rank programs for the gloo worlds of ``tests/test_torch_sharded_train.py``
and ``tests/test_torch_sharded_trainer.py`` (run by
``repro_torch.launch.world.run_world``; each returns plain numpy values)."""

from __future__ import annotations

import torch

from repro_torch.checkpoint import CheckpointManager, reshard
from repro_torch.launch.mesh import AXES, AXES_MULTI_POD, Mesh
from repro_torch.launch.steps import _like, apply_grads, grads_of
from repro_torch.models import transformer as T
from repro_torch.optim import (compressed_psum, compressed_psum_exact,
                               make_optimizer, state_specs)


def mesh_of(shape, device="cpu") -> Mesh:
    return Mesh(shape, AXES if len(shape) == 2 else AXES_MULTI_POD,
                device=device)


def np_tree(tree):
    return {k: np_tree(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def train_cases(shape, cases) -> dict:
    """Each case (a config, the JAX package's parameters as numpy, the
    global batch as numpy, ``n_micro``) trained one step on the mesh
    ``shape``: ``grads_of`` then ``apply_grads``.  Every rank returns its
    loss and gradient norm; rank 0 also the full gradients and parameters
    (``unshard_tree``) and the bytes it handed to the collectives."""
    mesh = mesh_of(shape)
    out = {"rank": mesh.rank}
    for c in cases:
        cfg = c["cfg"]
        before = sum(mesh.sent_bytes.values()), mesh.layout_bytes
        model = T.params_from_reference(cfg, c["params"], mesh=mesh)
        opt = make_optimizer(cfg, lr=c["lr"])
        params = model.params.tree()
        state = opt.init(params, mesh=mesh, pspecs=model.pspecs)
        batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
        loss, grads = grads_of(model, batch, c["n_micro"])
        with torch.no_grad():
            full_g = T.unshard_tree(_like(params, grads), model.pspecs, mesh)
        state, gnorm = apply_grads(model, opt, state, grads)
        with torch.no_grad():
            full_p = T.unshard_tree(params, model.pspecs, mesh)
        got = {"loss": float(loss), "grad_norm": float(gnorm),
               "step": int(state["step"]),
               "sent": sum(mesh.sent_bytes.values()) - before[0],
               "layout": mesh.layout_bytes - before[1]}
        if mesh.rank == 0:
            got.update(grads=np_tree(full_g), params=np_tree(full_p))
        out[c["name"]] = got
    return out


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def checkpoints(cfg, params, batch, ckpt_dir: str, jax_dir: str) -> dict:
    """On (2, 2): a model and its optimizer state after one step, saved
    sharded into ``ckpt_dir`` (rank 0 writes the full leaves) and restored;
    the JAX package's checkpoint in ``jax_dir`` restored onto (2, 2); then
    the live tree moved to (1, 4) by ``reshard`` and restored there from
    the file, each against a fresh (1, 4) placement of the full leaves."""
    mesh = mesh_of((2, 2))
    model = T.params_from_reference(cfg, params, mesh=mesh)
    opt = make_optimizer(cfg)
    tree = model.params.tree()
    state = opt.init(tree, mesh=mesh, pspecs=model.pspecs)
    _, grads = grads_of(model, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    state, _ = apply_grads(model, opt, state, grads)
    specs = {"params": model.pspecs, "opt": state_specs(state, model.pspecs)}
    live = {"params": tree, "opt": state}
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, live, shardings=(mesh, specs))
    with torch.no_grad():
        full = T.unshard_tree(live, specs, mesh)
    out = {"rank": mesh.rank,
           "roundtrip": _tree_equal(mgr.restore(live,
                                                shardings=(mesh, specs)),
                                    live)}
    if mesh.rank == 0:
        out["full"] = np_tree(full)
    jback = CheckpointManager(jax_dir).restore(
        {"params": tree}, shardings=(mesh, {"params": model.pspecs}))
    out["jax_blocks"] = np_tree(jback["params"])
    new = mesh_of((1, 4))
    nps = T.param_pspecs(cfg, new)
    nspecs = {"params": nps, "opt": state_specs(state, nps)}
    fresh = T.shard_tree(full, nspecs, new)
    moved = reshard(live, specs, mesh, nspecs, new)
    out["reshard_equal"] = _tree_equal(moved, fresh)
    out["restore_new_equal"] = _tree_equal(
        mgr.restore(moved, shardings=(new, nspecs)), fresh)
    out["blocks_smaller"] = all(
        a.numel() < b.numel() for a, b in zip(
            (moved["params"]["lm_head"], moved["params"]["embed"]["tok"]),
            (full["params"]["lm_head"], full["params"]["embed"]["tok"])))
    return out


def resize(cfg, ckpt_root: str, steps: int, fail_at: int) -> dict:
    """The Trainer on (2, 2): a run that never fails, then one that fails
    at ``fail_at`` with no restart budget, is resized onto (1, 4) and run
    again (restoring its last checkpoint resharded).  Each run's logged
    (step, loss, grad norm)."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig

    mesh = mesh_of((2, 2))
    data = SyntheticLMData(vocab=cfg.vocab, batch=4, seq=16, seed=0,
                           input_mode=cfg.input_mode, d_model=cfg.d_model,
                           encoder=cfg.encoder_layers > 0,
                           mrope=cfg.pos == "mrope")

    def trainer(name, fail):
        return Trainer(cfg, data,
                       TrainerConfig(steps=steps, ckpt_every=2,
                                     ckpt_dir=f"{ckpt_root}/{name}",
                                     lr=1e-3, max_restarts=0),
                       FaultInjector(fail_at=fail), mesh=mesh)

    clean = trainer("clean", {})
    clean.run()
    tr = trainer("faulty", {fail_at: "node loss"})
    try:
        tr.run()
        raised = False
    except RuntimeError:
        raised = True
    tr.resize(mesh_of((1, 4)))
    out = tr.run()

    def log(t):
        return [(m["step"], m["loss"], m["grad_norm"]) for m in t.metrics]

    return {"raised": raised, "out": out, "faulty": log(tr),
            "clean": log(clean), "mesh": tr.model.mesh.shape,
            "ckpts": tr.ckpt.steps()}


def compressed(cases) -> list:
    """For each case (mesh shape, axis, per-rank tensors, per-rank
    residuals): ``compressed_psum`` and ``compressed_psum_exact`` of this
    rank's tensor and residual over ``axis`` of that mesh."""
    out = []
    for shape, axis, xs, errs in cases:
        mesh = mesh_of(shape)
        x = torch.from_numpy(xs[mesh.rank])
        e = torch.from_numpy(errs[mesh.rank])
        got = {}
        for name, fn in (("psum", compressed_psum),
                         ("exact", compressed_psum_exact)):
            y, ne = fn(x, axis, e, mesh=mesh)
            got[name] = (y.numpy(), ne.numpy())
        out.append(got)
    return out
