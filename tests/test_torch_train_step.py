"""The port's train step (``launch/steps.py::build_train_step``) against
the JAX package's composition, on the CPU.

The JAX trainer cannot serve as the oracle (its step builder needs a mesh,
and its own trainer tests are red), so the oracle is what that step
computes, without a mesh: ``jax.value_and_grad(repro.models.transformer
.loss_fn)`` over ``repro.launch.steps._split_micro``'s microbatches, f32
gradient sums divided by ``n_micro``, the f32 global norm, then
``repro.optim.make_optimizer(cfg).update`` and ``p + u.astype(p.dtype)``.
Weights come from the JAX package's ``init_params``, batches from its
``SyntheticLMData``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.launch.steps import _split_micro as jsplit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamW, Adafactor  # noqa: E402

LR = 3e-4


def _jax_step(jcfg, n_micro):
    """The JAX package's train step without a mesh (the loss and gradient
    jitted, the composition around them eager)."""
    opt = jmake_optimizer(jcfg, lr=LR)
    vg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(jcfg, p, b),
                                    has_aux=True))

    def step(params, state, batch):
        if n_micro > 1:
            micro = jsplit(batch, n_micro)
            gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                params)
            lsum = 0.0
            for i in range(n_micro):
                (loss, _), g = vg(params, jax.tree.map(lambda x: x[i],
                                                       micro))
                gsum = jax.tree.map(jnp.add, gsum, g)
                lsum = lsum + loss
            grads = jax.tree.map(lambda g: (g / n_micro).astype(jnp.float32),
                                 gsum)
            loss = lsum / n_micro
        else:
            (loss, _), grads = vg(params, batch)
        gnorm = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                             for g in jax.tree.leaves(grads)))
        upd, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u.astype(p.dtype), params,
                              upd)
        return params, state, loss, gnorm

    return step, opt


def _params(ref, model_tree, path=""):
    for k, v in ref.items():
        if isinstance(v, dict):
            yield from _params(v, model_tree[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(v), model_tree[k].detach().numpy()


@pytest.fixture(autouse=True)
def _one_thread():
    """Smoke-size tensors: one intra-op thread is the faster, and keeps the
    test's time steady when other processes load the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,opt_type,n_micro", [
    ("qwen2-7b", AdamW, 1), ("qwen2-7b", AdamW, 2),
    ("jamba-1.5-large-398b", Adafactor, 2)])
def test_train_step_matches_jax_composition(arch, opt_type, n_micro):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = JT.init_params(jcfg, 0)
    model = T.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")
    data = JData(vocab=cfg.vocab, batch=4, seq=16, seed=3)
    jstep, jopt = _jax_step(jcfg, n_micro)
    step, opt = steps.build_train_step(cfg, n_micro=n_micro, lr=LR)
    assert type(opt) is opt_type and opt == type(opt)(**{
        f: getattr(jopt, f) for f in opt.__dataclass_fields__})
    jstate, state = jopt.init(jp), opt.init(model.params.tree())
    for i in range(3):
        batch = data.batch_at(i)
        jp, jstate, jloss, jnorm = jstep(
            jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(model, state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jloss),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jnorm),
                                   rtol=1e-5)
    assert int(state["step"]) == int(jstate["step"]) == 3
    # Adafactor is continuous in the gradient: every parameter within
    # rtol=1e-5, atol 1e-5 x the leaf's scale.  AdamW's first steps move a
    # parameter by about lr whatever |g| (u = m/(sqrt(v)+eps)); where |g|
    # is near eps = 1e-8, float32 rounding of g moves u by a visible
    # fraction, so a parameter is held to 5% of one step's move.
    for path, want, got in _params(jp, model.params):
        scale = min(1.0, float(np.abs(want).max()))
        atol = 0.05 * LR if opt_type is AdamW else 1e-5 * scale
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=path)


def test_split_micro_matches_jax():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (4, 6)).astype(np.int32),
             "embeds": rng.normal(size=(4, 6, 3)).astype(np.float32),
             "positions": rng.integers(0, 9, (3, 4, 6)).astype(np.int32)}
    want = jsplit({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = steps._split_micro({k: torch.from_numpy(v)
                              for k, v in batch.items()}, 2)
    assert len(got) == 2
    for i, mb in enumerate(got):
        for k, v in mb.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][i]))


def test_train_step_updates_in_place_and_reduces_loss():
    """Repeating one batch, the loss falls: the update is applied to the
    model's own parameters."""
    cfg = get_smoke_config("qwen2-7b").scaled(n_layers=2)
    model = T.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    step, opt = steps.build_train_step(cfg, lr=1e-2)
    state = opt.init(model.params.tree())
    batch = {k: torch.from_numpy(v) for k, v in JData(
        vocab=cfg.vocab, batch=2, seq=8, seed=1).batch_at(0).items()}
    ptr = model.params["final_norm"]["scale"].data_ptr()
    losses = [float(step(model, state, batch)[1]["loss"]) for _ in range(5)]
    assert model.params["final_norm"]["scale"].data_ptr() == ptr
    assert losses[-1] < losses[0]
