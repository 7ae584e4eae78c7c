"""Training on a mesh around the step, on the CPU over gloo: the optimizer
state specs, the compressed all-reduces, sharded checkpoints and
``reshard``, ``Trainer.resize`` and the launcher on a world of ranks.

* ``state_pspecs`` / ``opt_state_pspecs`` equal the JAX package's, entry
  for entry, for every config on the meshes of
  tests/test_torch_sharding_specs.py, for AdamW and Adafactor;
  ``state_specs`` gives the tree ``init`` made on a mesh.
* ``compressed_psum`` and ``compressed_psum_exact`` on a gloo world of 4
  against ``jax.vmap(..., axis_name=)`` over the same per-rank inputs:
  the new residual bit for bit (which pins the int8 payload: the residual
  is the target less the payload times the scale), the output within
  1e-6 relative; over the whole world and over ``data`` of (2, 2).
* A sharded checkpoint (the smoke Jamba and its Adafactor state after a
  step, on (2, 2)) restores in the JAX ``CheckpointManager`` bit for bit;
  a JAX checkpoint restores onto (2, 2) as the blocks of its leaves;
  ``reshard`` (2, 2) -> (1, 4) equals a fresh blockwise placement, and so
  does restoring the file onto (1, 4).
* ``Trainer.resize``: a (2, 2) run that fails, resizes onto (1, 4) and
  resumes from its checkpoint logs losses within 1e-5 relative of an
  uninterrupted (2, 2) run's, which are within 1e-5 of a single-device
  trainer's.
* ``launch/train.py --smoke --device cpu`` on a world of 2 ranks, on
  (2, 1) and (1, 2).
"""

import os
import types
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro.optim.optimizers import AdamW as JAdamW  # noqa: E402
from repro.optim.optimizers import Adafactor as JAdafactor  # noqa: E402
from repro.optim.optimizers import opt_state_pspecs as jopt_specs  # noqa
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import (AdamW, Adafactor,  # noqa: E402
                               opt_state_pspecs, state_specs)
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

WORLD_TIMEOUT_S = 300
TESTS = str(Path(__file__).resolve().parent)
JAMBA = "jamba-1.5-large-398b"
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (16, 16), (2, 16, 16)]
StubMesh = namedtuple("StubMesh", ["axis_names", "shape"])


def _run(target: str, n: int, args=()):
    """run_world with this directory on the ranks' PYTHONPATH."""
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [TESTS] + [p for p in (old or "").split(os.pathsep) if p])
    try:
        return run_world(target, n, args=args, backend="gloo",
                         timeout_s=WORLD_TIMEOUT_S)
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _flat_jax(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(k.key) for k in path): tuple(x)
            for path, x in leaves}


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


# ---------------------------------------------------------------- specs
@pytest.mark.parametrize("shape", MESHES,
                         ids=["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("arch", list_archs())
def test_state_pspecs_equal_jax(arch, shape):
    jm = types.SimpleNamespace(axis_names=_names(shape),
                               devices=np.empty(shape))
    pspecs = T.param_pspecs(get_config(arch), StubMesh(_names(shape), shape))
    jpspecs = JT.param_pspecs(jget_config(arch), jm)
    for opt, jopt in ((AdamW(), JAdamW()), (Adafactor(), JAdafactor())):
        want = _flat_jax(jopt_specs(jopt, jpspecs))
        assert _flat(opt_state_pspecs(opt, pspecs)) == want
        assert _flat(opt.state_pspecs(pspecs)) == want


def test_state_specs_follow_the_state_init_made():
    """On a stub (2, 2) mesh the smoke Jamba's groups of one layer stack
    its 1-D leaves as [1, d]: ``init`` keeps them unfactored ("v"), where
    JAX's ``state_pspecs`` (decided by the spec's length) says vr/vc;
    ``state_specs`` follows the tree and gives each leaf its block's
    spec."""
    cfg = get_smoke_config(JAMBA)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    stub = StubMesh(("data", "model"), (2, 2))
    pspecs = T.param_pspecs(cfg, stub)
    state = Adafactor().init(params)
    specs = state_specs(state, pspecs)
    f, sp = state["f"]["dec"]["sub0"], specs["f"]["dec"]["sub0"]
    assert set(f["ln1"]["scale"]) == {"v"}
    assert sp["ln1"]["scale"]["v"] == pspecs["dec"]["sub0"]["ln1"]["scale"]
    wq = pspecs["dec"]["sub7"]["mixer"]["wq"]
    assert specs["f"]["dec"]["sub7"]["mixer"]["wq"] == {
        "vr": wq[:-1], "vc": wq[:-2] + wq[-1:]}
    assert state_specs(AdamW().init(params), pspecs) == {
        "m": pspecs, "v": pspecs, "step": ()}
    # every state leaf splits by its spec on the stub mesh
    for s_leaf, spec in zip(_flat(state).values(), _flat(specs).values()):
        T.shard_tree({"x": s_leaf}, {"x": spec}, stub, rank=3)


# ---------------------------------------------------- compressed psums
COMPRESSED = {"mixed_scales": (0, (1e-3, 1.0, 10.0, 0.1), False),
              "with_residual": (1, (1.0, 1.0, 1.0, 1.0), True),
              "one_scale": (2, (2.0, 2.0, 2.0, 2.0), True)}


def _compressed_inputs(name):
    seed, scales, residual = COMPRESSED[name]
    rng = np.random.default_rng(seed)
    xs = np.stack([rng.normal(0, s, (6, 33)) for s in scales]).astype(
        np.float32)
    errs = (rng.normal(0, 1e-3, xs.shape) if residual
            else np.zeros(xs.shape)).astype(np.float32)
    return xs, errs


COMPRESSED_MESHES = [((1, 4), "model"), ((2, 2), "data")]
_COMPRESSED: list = []


def _compressed_world() -> list:
    """One world of 4 runs every case: [rank][case index]."""
    if not _COMPRESSED:
        cases = [(shape, axis, *_compressed_inputs(name))
                 for shape, axis in COMPRESSED_MESHES for name in COMPRESSED]
        _COMPRESSED.extend(_run("_torch_train_worker:compressed", 4,
                                (cases,)))
    return _COMPRESSED


@pytest.mark.parametrize("name", list(COMPRESSED))
@pytest.mark.parametrize("shape,axis", COMPRESSED_MESHES,
                         ids=["world", "data_of_2x2"])
def test_compressed_psums_match_jax_vmap(name, shape, axis):
    xs, errs = _compressed_inputs(name)
    at = COMPRESSED_MESHES.index((shape, axis)) * len(COMPRESSED) + list(
        COMPRESSED).index(name)
    outs = [ranks[at] for ranks in _compressed_world()]
    for variant, jfn in (("psum", JC.compressed_psum),
                         ("exact", JC.compressed_psum_exact)):
        if axis == "model":        # the whole world: one group of 4
            y, ne = jax.vmap(lambda x, e: jfn(x, "i", e), axis_name="i")(
                jnp.asarray(xs), jnp.asarray(errs))
            y, ne = np.asarray(y), np.asarray(ne)
        else:       # data of (2, 2): rank = 2 d + m, groups {0, 2}, {1, 3}
            f = jax.vmap(jax.vmap(lambda x, e: jfn(x, "data", e),
                                  axis_name="model"), axis_name="data")
            y, ne = f(jnp.asarray(xs.reshape(2, 2, 6, 33)),
                      jnp.asarray(errs.reshape(2, 2, 6, 33)))
            y, ne = (np.asarray(a).reshape(4, 6, 33) for a in (y, ne))
        for r, o in enumerate(outs):
            got_y, got_e = o[variant]
            np.testing.assert_array_equal(got_e, ne[r])
            np.testing.assert_allclose(got_y, y[r], rtol=1e-6,
                                       atol=1e-6 * np.abs(y[r]).max())


# ---------------------------------------------------------- checkpoints
_CKPT: dict = {}


def _checkpoint_world(tmp_path_factory):
    if not _CKPT:
        cfg, jcfg = get_smoke_config(JAMBA), jget_smoke(JAMBA)
        jp = JT.init_params(jcfg, 0)
        params = jax.tree.map(np.asarray, jp)
        root = tmp_path_factory.mktemp("sharded_ckpt")
        JManager(str(root / "jax")).save(5, {"params": jp})
        batch = JData(vocab=cfg.vocab, batch=4, seq=16, seed=3).batch_at(0)
        outs = _run("_torch_train_worker:checkpoints", 4,
                    (cfg, params, batch, str(root / "port"),
                     str(root / "jax")))
        _CKPT.update(cfg=cfg, jcfg=jcfg, params=params, root=root,
                     outs=outs)
    return _CKPT


def test_sharded_checkpoint_restores_in_jax(tmp_path_factory):
    w = _checkpoint_world(tmp_path_factory)
    full = w["outs"][0]["full"]
    jp = jax.tree.map(jnp.asarray, w["params"])
    like = {"params": jp, "opt": JAdafactor().init(jp)}
    back = JManager(str(w["root"] / "port")).restore(like)
    got, want = _flat(full), _flat_jax_arrays(back)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert all(o["roundtrip"] for o in w["outs"])


def _flat_jax_arrays(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in leaves}


def test_jax_checkpoint_restores_onto_a_mesh(tmp_path_factory):
    w = _checkpoint_world(tmp_path_factory)
    stub = StubMesh(("data", "model"), (2, 2))
    specs = T.param_pspecs(w["cfg"], stub)
    full = T._map(lambda a: torch.from_numpy(np.array(a)), w["params"])
    for o in w["outs"]:
        want = T.shard_tree(full, specs, stub, rank=o["rank"])
        got = _flat(o["jax_blocks"])
        for k, v in _flat(want).items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_reshard_2x2_to_1x4_equals_a_fresh_placement(tmp_path_factory):
    w = _checkpoint_world(tmp_path_factory)
    for o in w["outs"]:
        assert o["reshard_equal"] and o["restore_new_equal"]
        assert o["blocks_smaller"]


# -------------------------------------------------------------- trainer
def test_trainer_resize_resumes_within_1e5_of_an_uninterrupted_run(
        tmp_path):
    cfg = get_smoke_config(JAMBA)
    outs = _run("_torch_train_worker:resize", 4,
                (cfg, str(tmp_path), 6, 3))
    single = Trainer(cfg, SyntheticLMData(vocab=cfg.vocab, batch=4, seq=16,
                                          seed=0),
                     TrainerConfig(steps=6, ckpt_every=2, lr=1e-3,
                                   ckpt_dir=str(tmp_path / "single")),
                     device="cpu")
    single.run()
    want = {m["step"]: m["loss"] for m in single.metrics}
    for o in outs:
        assert o["raised"] and o["mesh"] == (1, 4)
        assert o["out"]["steps_run"] == 7 and o["ckpts"] == [2, 4, 6]
        assert [s for s, *_ in o["faulty"]] == [0, 1, 2, 2, 3, 4, 5]
        clean = {s: loss for s, loss, _ in o["clean"]}
        for step, loss, _ in o["faulty"]:
            np.testing.assert_allclose(loss, clean[step], rtol=1e-5)
        for step, loss in clean.items():
            np.testing.assert_allclose(loss, want[step], rtol=1e-5)
    assert outs[0]["faulty"] == outs[-1]["faulty"]


@pytest.mark.parametrize("model", [1, 2])
def test_launch_train_on_a_world_of_two_ranks(tmp_path, model):
    argv = ["--arch", JAMBA, "--smoke", "--steps", "4", "--ckpt-every",
            "2", "--fail-at", "3", "--ckpt", str(tmp_path), "--device",
            "cpu", "--model", str(model), "--batch", "4", "--seq", "16"]
    outs = _run("repro_torch.launch.train:main", 2, (argv,))
    assert outs[0] == outs[1]
    assert outs[0]["restarts"] == 1 and outs[0]["steps_run"] == 5
    assert np.isfinite(outs[0]["final_loss"])
