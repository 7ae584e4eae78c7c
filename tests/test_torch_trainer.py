"""The port's fault-tolerant trainer, launcher and example on the CPU.

The port's counterparts of tests/test_substrates.py's four trainer tests
(which are red in the JAX package: its trainer's step builder trips over
the host mesh), plus restart-exactness held bit for bit: on the CPU every
step is deterministic, so a run that fails and resumes from its last
checkpoint logs the same losses as one that never failed.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.runtime import (FaultInjector, InjectedFault,  # noqa: E402
                                 Trainer, TrainerConfig)


@pytest.fixture(autouse=True)
def _one_thread():
    """Smoke-size tensors: one intra-op thread is the faster, and keeps the
    test's time steady when other processes load the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_trainer(ckpt_dir, injector=None, steps=8, arch="qwen2-7b"):
    cfg = get_smoke_config(arch).scaled(n_layers=2)
    data = SyntheticLMData(vocab=cfg.vocab, batch=4, seq=16, seed=0)
    tcfg = TrainerConfig(steps=steps, ckpt_every=3, ckpt_dir=str(ckpt_dir),
                         lr=1e-3)
    return Trainer(cfg, data, tcfg, injector=injector, device="cpu")


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = _tiny_trainer(tmp_path)
    out = tr.run()
    assert out["steps_run"] == 8
    assert np.isfinite(out["final_loss"])
    assert tr.ckpt.latest_step() == 8
    assert tr.ckpt.steps() == [3, 6, 8]


def test_trainer_survives_injected_failure_restart_exact(tmp_path):
    tr = _tiny_trainer(tmp_path / "a", FaultInjector(fail_at={5: "loss"}))
    out = tr.run()
    assert out["restarts"] == 1
    # restart-exact: steps 3..4 replayed after restoring the step-3 ckpt
    steps_seen = [m["step"] for m in tr.metrics]
    assert steps_seen == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    clean = _tiny_trainer(tmp_path / "b")
    clean.run()
    want = {m["step"]: (m["loss"], m["grad_norm"]) for m in clean.metrics}
    for m in tr.metrics:            # bit for bit, replays included
        assert (m["loss"], m["grad_norm"]) == want[m["step"]], m["step"]
    for a, b in zip(tr.model.parameters(), clean.model.parameters()):
        assert torch.equal(a, b)


def test_trainer_resumes_a_finished_run_from_its_checkpoint(tmp_path):
    """A new trainer on the same directory starts from the latest
    checkpoint: parameters and optimizer state come back exactly."""
    first = _tiny_trainer(tmp_path, steps=6)
    first.run()
    again = _tiny_trainer(tmp_path, steps=8)
    again.run()
    assert [m["step"] for m in again.metrics] == [6, 7]
    clean = _tiny_trainer(tmp_path / "clean", steps=8)
    clean.run()
    assert [m["loss"] for m in again.metrics] == \
        [m["loss"] for m in clean.metrics[6:]]


def test_trainer_restart_budget(tmp_path):
    class Always(FaultInjector):
        def check(self, step):
            if step == 2:
                raise InjectedFault("flaky node")

    tr = _tiny_trainer(tmp_path, Always(), steps=4)
    with pytest.raises(RuntimeError, match="restart budget"):
        tr.run()
    assert tr.restarts == tr.tcfg.max_restarts + 1


def test_straggler_watchdog(tmp_path):
    """A step delayed by 4x the slowest step so far is flagged (the delay
    is sized from the run's own steps, so a loaded CPU cannot hide it)."""
    class Slow(FaultInjector):
        def check(self, step):
            if step == 6:
                time.sleep(4 * max(m["time_s"] for m in tr.metrics) + 0.1)

    tr = _tiny_trainer(tmp_path, Slow())
    tr.run()
    assert tr.straggler_flags >= 1


def test_trainer_trains_a_mamba_hybrid(tmp_path):
    """Jamba's smoke config (Mamba, attention, experts; Adafactor) through
    the trainer, its Mamba gradients through the reverse scan."""
    tr = _tiny_trainer(tmp_path, steps=3, arch="jamba-1.5-large-398b")
    assert type(tr.opt).__name__ == "Adafactor"   # as the config names
    out = tr.run()
    assert np.isfinite(out["final_loss"]) and out["steps_run"] == 3


def test_trainer_defaults_to_cuda_and_cannot_resize(tmp_path):
    """A trainer defaults to CUDA; it cannot resize onto no mesh, and
    resizes a single-device run onto the unit mesh: the next ``run()``
    restores the latest checkpoint there and logs the losses of a run
    that never moved, bit for bit (one rank computes what the mesh-free
    model does)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, init_world

    cfg = get_smoke_config("qwen2-7b")
    data = SyntheticLMData(vocab=cfg.vocab, batch=2, seq=8)
    tcfg = TrainerConfig(steps=1, ckpt_dir=str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, data, tcfg)
    tr = Trainer(cfg, data, tcfg, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tr.resize(None)

    moved = _tiny_trainer(tmp_path / "moved", steps=6)
    moved.tcfg.steps = 3
    moved.run()
    init_world("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
               world_size=1)
    try:
        moved.resize(Mesh((1, 1), device="cpu"))
        assert moved.model is None
        moved.tcfg.steps = 6
        moved.run()
        assert moved.model.mesh is moved.mesh
    finally:
        dist.destroy_process_group()
    clean = _tiny_trainer(tmp_path / "clean", steps=6)
    clean.run()
    assert [m["step"] for m in moved.metrics] == list(range(6))
    assert [(m["loss"], m["grad_norm"]) for m in moved.metrics] == \
        [(m["loss"], m["grad_norm"]) for m in clean.metrics]


@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-small",
                                  "qwen2-vl-72b"])
def test_launch_train_smoke_on_cpu(tmp_path, arch, capsys):
    out = launch_train.main(["--arch", arch, "--smoke", "--steps", "4",
                             "--ckpt-every", "2", "--fail-at", "3",
                             "--ckpt", str(tmp_path), "--device", "cpu"])
    assert out["restarts"] == 1 and out["steps_run"] == 5
    assert np.isfinite(out["final_loss"])
    assert "device=cpu" in capsys.readouterr().out


def test_example_train_lm_on_cpu(tmp_path, capsys):
    out = train_lm.main(["--device", "cpu", "--ckpt", str(tmp_path),
                         "--fail-at", "7"])
    assert out["restarts"] == 1
    said = capsys.readouterr().out
    assert "restarts=1" in said and "on cpu" in said


def test_example_full_config_is_100m_f32():
    cfg, batch, seq = train_lm.full_config()
    assert cfg.dtype == "float32" and (batch, seq) == (8, 512)
    assert 90e6 < cfg.param_count() < 130e6
