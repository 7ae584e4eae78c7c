"""The port's sharded train step (``grads_of`` then ``apply_grads`` on a
``Transformer(cfg, mesh=)``) against the JAX package's mesh-free
composition, on the CPU over gloo.

The JAX trainer on a mesh is red (tests/test_substrates.py), so the
oracle is what its step computes without one, as in
tests/test_torch_train_step.py: ``jax.value_and_grad(repro.models
.transformer.loss_fn)`` over ``repro.launch.steps._split_micro``'s
microbatches, float32 gradient sums over ``n_micro``, the float32 global
norm, ``make_optimizer(cfg).update`` and ``p + u.astype(p.dtype)``.  The
weights are the JAX package's ``init_params``, carried onto the mesh by
``params_from_reference(..., mesh=)``; the batches its
``SyntheticLMData``'s.

Worlds of 2 and 4 ranks (``tests/_torch_train_worker.py``) train one
step on (data, model) = (1, 2), (2, 1), (2, 2), (1, 4) and (pod, data,
model) = (2, 1, 2): the smoke Jamba with its experts (attention, Mamba,
dense and MoE sub-layers) with Adafactor at n_micro 1 and with AdamW at
n_micro 2, on every mesh; granite-moe (grouped and ungrouped dispatch), rwkv6,
whisper-small and qwen2-vl (M-RoPE; also a batch of 3 rows, which does not
split over data, so every dp rank computes every row) on (2, 2).  On
(1, 4) a rank's one q head reads one of the 2 kv heads (trap 1: the
replicated ``wk``/``wv`` get partial gradients).  Float32, held to 1e-4
relative: the loss and gradient norm on every rank, and on rank 0 every
gradient and every updated parameter, gathered whole (``unshard_tree``).
Every world has a timeout.
"""

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.launch.steps import _split_micro as jsplit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402

LR = 3e-4
TOL = 1e-4
WORLD_TIMEOUT_S = 300
TESTS = str(Path(__file__).resolve().parent)
JAMBA = "jamba-1.5-large-398b"
# name -> (arch, config overrides, n_micro, global batch)
# (Jamba's two cases share one microbatch shape: one JAX compilation)
CASES = {
    "jamba_adafactor_1": (JAMBA, {}, 1, 2),
    "jamba_adamw_2": (JAMBA, {"optimizer": "adamw"}, 2, 4),
    "granite_moe": ("granite-moe-1b-a400m", {}, 1, 4),
    "granite_moe_ungrouped": ("granite-moe-1b-a400m",
                              {"moe_grouped_dispatch": False}, 2, 4),
    "rwkv6": ("rwkv6-1.6b", {}, 1, 4),
    "whisper": ("whisper-small", {}, 2, 4),
    "qwen2_vl": ("qwen2-vl-72b", {}, 1, 4),
    "qwen2_vl_3_rows": ("qwen2-vl-72b", {}, 1, 3),
}
MESHES = {
    (1, 2): ["jamba_adafactor_1", "jamba_adamw_2"],
    (2, 1): ["jamba_adafactor_1", "jamba_adamw_2"],
    (2, 2): ["jamba_adafactor_1", "jamba_adamw_2", "granite_moe",
             "granite_moe_ungrouped", "rwkv6", "whisper", "qwen2_vl",
             "qwen2_vl_3_rows"],
    (1, 4): ["jamba_adafactor_1", "jamba_adamw_2"],
    (2, 1, 2): ["jamba_adafactor_1", "jamba_adamw_2"],
}
PARAMS = [(shape, name) for shape, names in MESHES.items() for name in names]


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


def _case(name: str) -> dict:
    arch, over, n_micro, b = CASES[name]
    cfg = get_smoke_config(arch).scaled(**over)
    jcfg = jget_smoke(arch).scaled(**over)
    data = JData(vocab=cfg.vocab, batch=b, seq=16, seed=3,
                 input_mode=cfg.input_mode, d_model=cfg.d_model,
                 encoder=cfg.encoder_layers > 0, mrope=cfg.pos == "mrope")
    return {"name": name, "cfg": cfg, "jcfg": jcfg,
            "params": jax.tree.map(np.asarray, JT.init_params(jcfg, 0)),
            "batch": data.batch_at(0), "n_micro": n_micro, "lr": LR}


_REFS: dict = {}
_VG: dict = {}


def _value_and_grad(jcfg):
    """The jitted JAX gradient of one model (whatever its optimizer)."""
    key = repr(dataclasses.replace(jcfg, optimizer=None))
    if key not in _VG:
        _VG[key] = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))
    return _VG[key]


def _jax_ref(c: dict) -> dict:
    """The JAX composition's loss, norm, gradients and updated parameters
    for one case (computed once)."""
    if c["name"] in _REFS:
        return _REFS[c["name"]]
    jcfg, n_micro = c["jcfg"], c["n_micro"]
    params = jax.tree.map(jnp.asarray, c["params"])
    batch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    opt = jmake_optimizer(jcfg, lr=LR)
    vg = _value_and_grad(jcfg)
    if n_micro > 1:
        micro = jsplit(batch, n_micro)
        gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                            params)
        lsum = 0.0
        for i in range(n_micro):
            (loss, _), g = vg(params, jax.tree.map(lambda x: x[i], micro))
            gsum = jax.tree.map(jnp.add, gsum, g)
            lsum = lsum + loss
        grads = jax.tree.map(lambda g: (g / n_micro).astype(jnp.float32),
                             gsum)
        loss = lsum / n_micro
    else:
        (loss, _), grads = vg(params, batch)
    gnorm = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                         for g in jax.tree.leaves(grads)))
    upd, _ = opt.update(grads, opt.init(params), params)
    new = jax.tree.map(lambda p, u: p + u.astype(p.dtype), params, upd)
    _REFS[c["name"]] = ref = {
        "loss": float(loss), "grad_norm": float(gnorm),
        "grads": jax.tree.map(np.asarray, grads),
        "params": jax.tree.map(np.asarray, new),
        "adamw": type(opt).__name__ == "AdamW",
        "update": lambda g: jax.tree.map(
            lambda p, u: np.asarray(p + u.astype(p.dtype)), params,
            opt.update(jax.tree.map(jnp.asarray, g), opt.init(params),
                       params)[0])}
    return ref


_WORLDS: dict = {}


def _world(shape):
    if shape not in _WORLDS:
        cases = [_case(n) for n in MESHES[shape]]
        _WORLDS[shape] = _run("_torch_train_worker:train_cases",
                              int(np.prod(shape)),
                              (shape, [{k: v for k, v in c.items()
                                        if k != "jcfg"} for c in cases]))
    return _WORLDS[shape]


def _at(tree, path: str):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def _walk(ref, got, path=""):
    for k, v in ref.items():
        if isinstance(v, dict):
            yield from _walk(v, got[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(v), got[k]


@pytest.mark.parametrize("shape,name", PARAMS,
                         ids=[f"{'x'.join(map(str, s))}-{n}"
                              for s, n in PARAMS])
def test_sharded_step_matches_jax_composition(shape, name):
    outs = _world(shape)
    c = _case(name)
    ref = _jax_ref(c)
    assert [o["rank"] for o in outs] == list(range(len(outs)))
    for o in outs:
        got = o[name]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TOL)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=TOL)
        assert got["step"] == 1 and got["sent"] > 0
    got = outs[0][name]
    n = 0
    for path, want, g in _walk(ref["grads"], got["grads"]):
        if c["cfg"].pos not in ("rope", "mrope") and \
                path.endswith("mixer/bk"):
            # A bias added to every key shifts each query's logits by one
            # constant, which softmax removes: the exact gradient is 0 and
            # both hold float32 noise, held to the scale of the key
            # projection's gradient (as tests/test_torch_train.py holds it)
            tiny = 1e-6 * float(np.abs(_at(got["grads"],
                                           path[:-2] + "wk")).max())
            assert float(np.abs(g).max()) <= tiny, path
            continue
        scale = min(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g, want, rtol=TOL, atol=TOL * scale,
                                   err_msg=f"gradient {path}")
        n += 1
    assert n > 0
    # Each parameter after the step is the JAX optimizer's update from the
    # gathered gradient (this tests the sharded update: Adafactor's means
    # over split dimensions), and, Adafactor being continuous in the
    # gradient, the composition's.  AdamW's first step moves a parameter
    # by lr g / (|g| + 1e-8), so where |g| is near 1e-8 the rounding the
    # gradient check allows moves it by a visible fraction of lr: its
    # parameters are held to the update of their own gradient.
    wants = [ref["update"](got["grads"])]
    if not ref["adamw"]:
        wants.append(ref["params"])
    for target in wants:
        for path, want, p in _walk(target, got["params"]):
            scale = min(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(p, want, rtol=TOL, atol=TOL * scale,
                                       err_msg=f"parameter {path}")
