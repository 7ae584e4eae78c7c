"""The port's ``CheckpointManager`` and ``SyntheticLMData`` on the CPU:
the JAX package's substrate tests through the port, checkpoints crossing
the two packages in both directions, bf16 trees, and batches equal to the
JAX package's for every flag."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402


def _tree():
    rng = np.random.default_rng(0)
    return {"a": torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)),
            "b": {"c": torch.tensor(7, dtype=torch.int32),
                  "d": torch.arange(5, dtype=torch.int64)}}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_equal(got[k], v)
        else:
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_checkpoint_roundtrip_and_prune(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3):
        mgr.save(step, tree)
    assert mgr.steps() == [2, 3]  # pruned to keep=2
    assert sorted(os.listdir(tmp_path)) == ["step_000002", "step_000003"]
    _assert_equal(mgr.restore(tree), tree)
    man = json.load(open(tmp_path / "step_000003" / "manifest.json"))
    assert man["step"] == 3
    assert sorted(man["leaves"]) == ["a", "b__c", "b__d"]
    assert man["leaves"]["b__c"]["dtype"] == "int32"


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones((4,))}
    path = mgr.save(1, tree)
    with open(os.path.join(path, "w.npy"), "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\x42")
    with pytest.raises(IOError):
        mgr.restore(tree, verify=True)
    assert float(mgr.restore(tree, verify=False)["w"][0]) == 1.0


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = {"w": torch.ones((128, 128))}
    mgr.save(5, tree)
    tree["w"].add_(1.0)           # updated in place while the save runs
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(tree)["w"], torch.ones((128, 128)))


def test_checkpoint_tmp_dir_is_not_a_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_000009.tmp"))
    assert mgr.latest_step() is None  # crash-atomic: tmp dirs invisible
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(1)})


def test_jax_checkpoint_restores_in_port(tmp_path):
    rng = np.random.default_rng(1)
    jtree = {"params": {"w": jnp.asarray(rng.normal(size=(3, 4)),
                                         jnp.float32)},
             "opt": {"m": {"w": jnp.zeros((3, 4))},
                     "step": jnp.asarray(4, jnp.int32)}}
    JManager(str(tmp_path)).save(4, jtree)
    like = {"params": {"w": torch.zeros(3, 4)},
            "opt": {"m": {"w": torch.zeros(3, 4)}, "step": torch.zeros(())}}
    got = CheckpointManager(str(tmp_path)).restore(like)
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  np.asarray(jtree["params"]["w"]))
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 4


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = _tree()
    CheckpointManager(str(tmp_path)).save(2, tree)
    like = {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros((), jnp.int32),
                                          "d": jnp.zeros((5,), jnp.int32)}}
    got = JManager(str(tmp_path)).restore(like)
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"].numpy())
    assert int(got["b"]["c"]) == 7


def test_both_packages_write_the_same_files(tmp_path):
    """f32 and int32 leaves: the same keys, shapes, dtypes and sha256s."""
    x = np.random.default_rng(4).normal(size=(3, 5)).astype(np.float32)
    CheckpointManager(str(tmp_path / "port")).save(2, {
        "a": torch.from_numpy(x),
        "b": {"c": torch.tensor(7, dtype=torch.int32)}})
    JManager(str(tmp_path / "jax")).save(2, {
        "a": jnp.asarray(x), "b": {"c": jnp.asarray(7, jnp.int32)}})
    mine, theirs = (json.load(open(tmp_path / d / "step_000002" /
                                   "manifest.json")) for d in ("port", "jax"))
    assert mine["leaves"] == theirs["leaves"]


def test_bf16_tree_roundtrips_in_port(tmp_path):
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32))
    tree = {"w": w.to(torch.bfloat16), "f": w.clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    man = json.load(open(tmp_path / "step_000001" / "manifest.json"))
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    got = mgr.restore(tree)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16),
                       tree["w"].view(torch.int16))       # bit for bit
    assert torch.equal(got["f"], tree["f"])


def test_jax_bf16_checkpoint_restores_in_port(tmp_path):
    x = np.random.default_rng(3).normal(size=(4, 6)).astype(np.float32)
    jw = jnp.asarray(x, jnp.bfloat16)
    JManager(str(tmp_path)).save(1, {"w": jw})
    got = CheckpointManager(str(tmp_path)).restore({"w": None})["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(jw.astype(jnp.float32)))


@pytest.mark.parametrize("flags", [
    {}, {"input_mode": "embeds", "d_model": 8}, {"encoder": True,
                                                 "d_model": 8},
    {"mrope": True}, {"host_id": 1, "n_hosts": 2},
    {"input_mode": "embeds", "d_model": 8, "mrope": True, "encoder": True},
], ids=["tokens", "embeds", "encoder", "mrope", "host1", "all"])
def test_synthetic_data_equals_jax(flags):
    kw = dict(vocab=100, batch=4, seq=8, seed=3, **flags)
    mine, theirs = SyntheticLMData(**kw), JData(**kw)
    for step in (0, 7, 123):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_data_restart_exact():
    a = SyntheticLMData(vocab=100, batch=4, seq=8, seed=3)
    b = SyntheticLMData(vocab=100, batch=4, seq=8, seed=3)
    for step in (0, 7, 123):
        np.testing.assert_array_equal(a.batch_at(step)["tokens"],
                                      b.batch_at(step)["tokens"])
    assert not np.array_equal(a.batch_at(1)["tokens"],
                              a.batch_at(2)["tokens"])
