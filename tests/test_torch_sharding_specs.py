"""The port's sharding specs and shard blocks against the JAX package's.

* ``param_pspecs``, ``cache_pspecs``, ``batch_specs``, ``cache_specs``
  (shapes, dtypes, specs) and ``microbatches``, for every config of
  ``repro.configs`` and every shape cell of ``SHAPES``, on meshes (1, 1),
  (2, 1), (1, 2), (2, 2), (1, 4), (16, 16) and (2, 16, 16): the JAX
  functions read only the mesh's axis names and device-array shape, so a
  stand-in without devices serves both packages and the trees are held
  equal exactly, in-process.
* ``shard_tree``'s blocks against JAX's ``NamedSharding(mesh, spec)
  .devices_indices_map`` and the shards ``jax.device_put`` places, on
  (data, model) meshes (2, 2), (2, 4) and (pod, data, model) (2, 2, 2) of
  8 host devices, in a subprocess (the device count is fixed before JAX
  starts), for a smoke config of every family.
"""

import json
import os
import subprocess
import sys
import types
from collections import namedtuple
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import shapes as PS  # noqa: E402
from repro_torch.launch.mesh import _axsize  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (16, 16), (2, 16, 16)]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
ARCHS = list_archs()
StubMesh = namedtuple("StubMesh", ["axis_names", "shape"])


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _meshes(shape):
    """(the JAX stand-in: axis names and a device array's shape; the
    port's: axis names and shape)."""
    jm = types.SimpleNamespace(axis_names=_names(shape),
                               devices=np.empty(shape))
    return jm, StubMesh(_names(shape), shape)


def _flat_jax(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        or isinstance(x, jax.ShapeDtypeStruct))[0]
    return {"/".join(str(k.key) for k in path): x for path, x in leaves}


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _same_specs(port_tree, jax_tree):
    want = {k: tuple(v) for k, v in _flat_jax(jax_tree).items()}
    assert _flat(port_tree) == want


def _same_abstract(port_tree, jax_tree):
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _flat_jax(jax_tree).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(port_tree).items()}
    assert all(v.device.type == "meta" for v in _flat(port_tree).values())
    assert got == want


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_jax(arch, shape):
    jm, pm = _meshes(shape)
    _same_specs(T.param_pspecs(get_config(arch), pm),
                JT.param_pspecs(jget_config(arch), jm))


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, shape):
    """``cache_pspecs`` at a small cache (batch 4, 64 positions, 12
    encoder frames), then ``cache_specs`` of every cell."""
    jm, pm = _meshes(shape)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for b, s_max in ((4, 64), (1, 64), (2, 6)):
        s_enc = 12 if cfg.encoder_layers else None
        _same_specs(T.cache_pspecs(cfg, pm, b, s_max, s_enc),
                    JT.cache_pspecs(jcfg, jm, b, s_max, s_enc))
    for name in JS.SHAPES:
        got_abs, got = PS.cache_specs(cfg, PS.SHAPES[name], pm)
        want_abs, want = JS.cache_specs(jcfg, JS.SHAPES[name], jm)
        _same_specs(got, want)
        _same_abstract(got_abs, want_abs)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_microbatches_equal_jax(arch, shape):
    jm, pm = _meshes(shape)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in JS.SHAPES:
        got_abs, got = PS.batch_specs(cfg, PS.SHAPES[name], pm)
        want_abs, want = JS.batch_specs(jcfg, JS.SHAPES[name], jm)
        _same_specs(got, want)
        _same_abstract(got_abs, want_abs)
        assert PS.microbatches(cfg, PS.SHAPES[name], pm) == \
            JS.microbatches(jcfg, JS.SHAPES[name], jm)
    assert _axsize(pm, pm.axis_names) == JS._axsize(jm, jm.axis_names) \
        == int(np.prod(shape))


# ------------------------------------------------------ blocks vs JAX
BLOCK_MESHES = [(2, 2), (2, 4), (2, 2, 2)]

_BLOCKS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
from collections import namedtuple
import jax, numpy as np, torch
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_smoke_config as jsmoke, list_archs
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.sharding import mesh_coords

Stub = namedtuple("Stub", ["axis_names", "shape"])
out = {}
for shape in (tuple(s) for s in json.loads(sys.argv[1])):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    n = int(np.prod(shape))
    jmesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
    rank_of = {d.id: r for r, d in enumerate(jmesh.devices.flat)}
    stub = Stub(names, shape)
    for arch in list_archs():
        cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
        rng = np.random.default_rng(0)
        bad = []
        trees = [(T.param_pspecs(cfg, stub), JT.param_pspecs(jcfg, jmesh),
                  T.param_template(cfg)),
                 (T.cache_pspecs(cfg, stub, 4, 16, 6),
                  JT.cache_pspecs(jcfg, jmesh, 4, 16, 6),
                  T.cache_template(cfg, 4, 16, 6))]
        checked = 0
        for specs, jspecs, tmpl in trees:
            flat = jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]
            for path, jspec in flat:
                keys = [k.key for k in path]
                spec, p = specs, tmpl
                for k in keys:
                    spec, p = spec[k], p[k]
                full = rng.normal(size=p.shape).astype(np.float32)
                sharding = NamedSharding(jmesh, jspec)
                placed = jax.device_put(full, sharding)
                shards = {rank_of[s.device.id]: np.asarray(s.data)
                          for s in placed.addressable_shards}
                for dev, idx in sharding.devices_indices_map(
                        p.shape).items():
                    r = rank_of[dev.id]
                    want = [(sl.indices(d)[0], sl.indices(d)[1])
                            for sl, d in zip(idx, p.shape)]
                    got_tree = T.shard_tree({"x": torch.from_numpy(full)},
                                            {"x": spec}, stub, rank=r)
                    sl = T.shard_slices(p.shape, spec, stub,
                                        mesh_coords(stub, r))
                    got = [(x.start, x.stop) for x in sl]
                    if got != want or not np.array_equal(
                            got_tree["x"].numpy(), shards[r]):
                        bad.append(["/".join(map(str, keys)), r, got, want])
                    checked += 1
        out["x".join(map(str, shape)) + "/" + arch] = {"bad": bad[:5],
                                                       "checked": checked}
print(json.dumps(out))
"""

_BLOCK_RESULTS: dict = {}


def _blocks() -> dict:
    if not _BLOCK_RESULTS:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src")] + [p for p in env.get(
                "PYTHONPATH", "").split(os.pathsep) if p])
        r = subprocess.run([sys.executable, "-c", _BLOCKS,
                            json.dumps(BLOCK_MESHES)], capture_output=True,
                           text=True, env=env, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        _BLOCK_RESULTS.update(json.loads(r.stdout.strip().splitlines()[-1]))
    return _BLOCK_RESULTS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", BLOCK_MESHES,
                         ids=["x".join(map(str, m)) for m in BLOCK_MESHES])
def test_shard_blocks_equal_jax_placement(shape, arch):
    res = _blocks()["x".join(map(str, shape)) + "/" + arch]
    assert res["checked"] > 0
    assert res["bad"] == []
