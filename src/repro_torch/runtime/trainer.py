"""Fault-tolerant training driver: checkpoint/restart, failure injection,
straggler watchdog, elastic re-mesh.

PyTorch port of ``repro.runtime.trainer``, on one device or on a mesh of
ranks (``launch.mesh.Mesh``; every rank runs the same trainer).  The
contract is the JAX package's:

  * every step is restart-exact: parameters and optimizer state come from
    the checkpoint, data from the stateless step-indexed pipeline;
  * failures (injected here) bounce the driver loop, which restores the
    last complete checkpoint and replays, within a restart budget;
  * the straggler watchdog flags steps slower than ``straggler_factor`` x
    the trailing median;
  * ``resize(new_mesh)`` rebuilds the step for a new mesh, and the next
    ``run()`` restores the latest checkpoint resharded onto it.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.otcd import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models.transformer import Transformer, param_pspecs
from repro_torch.optim import state_specs


class InjectedFault(RuntimeError):
    pass


@dataclasses.dataclass
class FaultInjector:
    """Raises at configured steps (once each) — simulated node failures."""
    fail_at: Dict[int, str] = dataclasses.field(default_factory=dict)
    delay_at: Dict[int, float] = dataclasses.field(default_factory=dict)
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.delay_at:
            time.sleep(self.delay_at[step])
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise InjectedFault(f"step {step}: {self.fail_at[step]}")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 10
    ckpt_every: int = 5
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    lr: float = 3e-4


class Trainer:
    """Trains ``model_cfg`` on ``data`` (``SyntheticLMData``): on one
    device, CUDA unless ``device`` names another (and raises where there
    is none), or sharded over ``mesh`` on its device.  The model starts
    from seed 0 on the device (on a mesh, each rank's blocks of that
    draw), or from the latest checkpoint in ``tcfg.ckpt_dir``.  On a mesh
    every rank passes the global batch and the step takes its rows (over
    the dp axes where they split evenly; the JAX trainer's batch layout),
    and the checkpoints hold the full leaves, as the JAX trainer's do."""

    def __init__(self, model_cfg, data, tcfg: TrainerConfig,
                 injector: Optional[FaultInjector] = None, *, device=None,
                 mesh=None):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.data = data
        if mesh is None:
            self.device = resolve_device(device, "Trainer")
        self.injector = injector or FaultInjector()
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.metrics: List[Dict[str, Any]] = []
        self.restarts = 0
        self.straggler_flags = 0
        self._build(mesh)

    # ------------------------------------------------------------ lifecycle
    def _build(self, mesh) -> None:
        """The step for ``mesh`` (None: the trainer's device); the model
        is built, or restored, by the next ``run()``."""
        self.mesh = mesh
        self.model: Optional[Transformer] = None
        self.pspecs = None
        if mesh is not None:
            self.device = mesh.device
            self.pspecs = param_pspecs(self.model_cfg, mesh)
        self.step_fn, self.opt = build_train_step(self.model_cfg, n_micro=1,
                                                  lr=self.tcfg.lr)

    def _opt_init(self):
        return self.opt.init(self.model.params.tree(), mesh=self.mesh,
                             pspecs=self.pspecs)

    def _shardings(self, opt_state):
        """(mesh, specs) of the checkpointed tree on a mesh, else None."""
        if self.mesh is None:
            return None
        return self.mesh, {"params": self.pspecs,
                           "opt": state_specs(opt_state, self.pspecs)}

    def _init_state(self):
        self.model = None           # free the old model first
        gen = torch.Generator(self.device).manual_seed(0)
        self.model = Transformer(self.model_cfg, generator=gen,
                                 device=None if self.mesh else self.device,
                                 mesh=self.mesh)
        return self._opt_init()

    def _restore(self, step: int):
        """The model and optimizer state of checkpoint ``step`` (on a
        mesh, this rank's blocks of them, whatever mesh wrote it)."""
        if self.model is None:
            self._init_state()
        params = self.model.params.tree()
        like = {"params": params, "opt": self._opt_init()}
        tree = self.ckpt.restore(like, step=step, device=self.device,
                                 shardings=self._shardings(like["opt"]))
        with torch.no_grad():
            _copy_into(params, tree["params"])
        return tree["opt"]

    # ----------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        attempts = 0
        while True:
            try:
                return self._run_once()
            except InjectedFault as e:
                attempts += 1
                self.restarts += 1
                if attempts > self.tcfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                # driver bounces; state comes back from the checkpoint

    def _run_once(self) -> Dict[str, Any]:
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            opt_state = self._restore(latest)
            start = latest
        else:
            opt_state = self._init_state()
        times: List[float] = []
        for step in range(start, self.tcfg.steps):
            t0 = time.perf_counter()
            # injected delays land inside the timed window (they simulate a
            # slow step); injected faults abort it like a real node loss
            self.injector.check(step)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch_at(step).items()}
            opt_state, m = self.step_fn(self.model, opt_state, batch)
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
            if len(times) >= 3:
                med = statistics.median(times[-8:])
                if dt > self.tcfg.straggler_factor * med:
                    self.straggler_flags += 1
            times.append(dt)
            self.metrics.append({"step": step, "loss": loss,
                                 "grad_norm": float(m["grad_norm"]),
                                 "time_s": dt})
            if (step + 1) % self.tcfg.ckpt_every == 0 \
                    or step + 1 == self.tcfg.steps:
                self.ckpt.save(step + 1, {"params": self.model.params.tree(),
                                          "opt": opt_state},
                               shardings=self._shardings(opt_state))
        self.ckpt.wait()
        return {"final_loss": self.metrics[-1]["loss"],
                "steps_run": len(self.metrics),
                "restarts": self.restarts,
                "straggler_flags": self.straggler_flags}

    # -------------------------------------------------------------- elastic
    def resize(self, new_mesh) -> None:
        """Elastic re-mesh, as the JAX trainer's: rebuild the step for
        ``new_mesh``; the next ``run()`` restores the latest checkpoint
        resharded onto it (from the start, without one).  A torch world
        cannot grow or shrink, so ``new_mesh`` lays out the ranks this
        trainer already runs on anew: (2, 2) -> (1, 4), say, or a
        single-device trainer's one rank onto the unit mesh."""
        if new_mesh is None:
            raise ValueError("Trainer.resize needs a mesh (launch.mesh.Mesh)"
                             " over the ranks of this world")
        self.ckpt.wait()
        self._build(new_mesh)


def _copy_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        else:
            v.copy_(src[k])
