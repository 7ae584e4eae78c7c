"""The port's optimizers and int8 quantization against the JAX package,
on the CPU: the same seeded numpy trees through both, five steps."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jo  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch import optim as po  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402


def _tree(rng, dtype=np.float32):
    """Leaves of every kind Adafactor tells apart: a matrix (factored), a
    vector, a [1, n] row and a [n, 1] column (unfactored), a stacked
    [groups, a, b] tensor (factored over its last two) and a scalar."""
    shapes = {"w": (6, 10), "b": (7,), "row": (1, 5), "col": (5, 1),
              "stack": {"x": (2, 3, 4)}, "s": ()}

    def make(v):
        if isinstance(v, dict):
            return {k: make(x) for k, x in v.items()}
        return rng.normal(size=v).astype(dtype)

    return make(shapes)


def _map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    return fn(*trees)


def _to_torch(tree, dtype=torch.float32):
    return _map(lambda a: torch.from_numpy(np.asarray(a)).to(dtype), tree)


def _check_tree(got, want, tol=1e-6):
    def one(g, w):
        w = np.asarray(w, dtype=np.float32)
        g = g.to(torch.float32).numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        scale = min(1.0, float(np.abs(w).max())) if w.size else 1.0
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale)
    _map(one, got, want)


@pytest.mark.parametrize("pair", [
    (jo.AdamW(), po.AdamW()),
    (jo.AdamW(state_dtype="bfloat16"), po.AdamW(state_dtype="bfloat16")),
    (jo.AdamW(lr=1e-2, weight_decay=0.0, b2=0.99),
     po.AdamW(lr=1e-2, weight_decay=0.0, b2=0.99)),
    (jo.Adafactor(), po.Adafactor()),
    (jo.Adafactor(clip_threshold=0.05, weight_decay=0.01),
     po.Adafactor(clip_threshold=0.05, weight_decay=0.01)),
], ids=["adamw", "adamw-bf16-state", "adamw-no-decay", "adafactor",
        "adafactor-clipped"])
def test_optimizer_matches_jax_over_five_steps(pair):
    jopt, popt = pair
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp, pp = _map(jnp.asarray, params), _to_torch(params)
    js, ps = jopt.init(jp), popt.init(pp)
    assert jax.tree.structure(js) == jax.tree.structure(
        _map(lambda t: 0, ps))          # the same state tree, key for key
    for _ in range(5):
        grads = _tree(rng)
        ju, js = jopt.update(_map(jnp.asarray, grads), js, jp)
        pu, ps = popt.update(_to_torch(grads), ps, pp)
        _check_tree(pu, ju)
        _check_tree({k: v for k, v in ps.items() if k != "step"},
                    {k: v for k, v in js.items() if k != "step"})
        assert int(ps["step"]) == int(js["step"])
        assert ps["step"].dtype == torch.int32
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        pp = _map(lambda p, u: p + u, pp, pu)
    _check_tree(pp, jp)


def test_adamw_bf16_state_is_bf16():
    st = po.AdamW(state_dtype="bfloat16").init({"w": torch.zeros(3, 4)})
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", list_archs())
def test_make_optimizer_chooses_as_jax(arch):
    want = jo.make_optimizer(jget_config(arch), lr=1e-3)
    got = po.make_optimizer(get_config(arch), lr=1e-3)
    assert type(got).__name__ == type(want).__name__
    for f in want.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f


def test_make_optimizer_big_adamw_keeps_bf16_moments():
    cfg = get_config("qwen2-7b").scaled(n_layers=300)   # > 5e10 parameters
    assert cfg.param_count() > 5e10
    assert po.make_optimizer(cfg).state_dtype == "bfloat16"
    assert po.make_optimizer(get_config("qwen2-7b")).state_dtype == "float32"


@pytest.mark.parametrize("x", [
    np.random.default_rng(1).normal(0, 3, (256, 64)).astype(np.float32),
    # halves after scaling: amax 127 gives scale 1, and 0.5, 1.5, 2.5 round
    # to even as jnp.round does
    np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.49, -126.5],
             dtype=np.float32),
    np.zeros((4,), np.float32),
], ids=["normal", "ties", "zeros"])
def test_quantize_int8_bit_equal_to_jax(x):
    jq, js = jo.quantize_int8(jnp.asarray(x))
    q, s = po.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.dtype == torch.float32 and float(s) == float(js)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        d = po.dequantize_int8(q, s, td).to(torch.float32).numpy()
        np.testing.assert_array_equal(
            d, np.asarray(jo.dequantize_int8(jq, js, jd), np.float32))


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3, (256, 64))
                         .astype(np.float32))
    q, s = po.quantize_int8(x)
    assert float((po.dequantize_int8(q, s) - x).abs().max()) <= \
        float(s) * 0.5 + 1e-6


@pytest.mark.parametrize("opt", [po.AdamW(lr=0.1), po.Adafactor(lr=0.5)],
                         ids=["adamw", "adafactor"])
def test_optimizer_descends_quadratic(opt):
    """tests/test_substrates.py's quadratic, through the port."""
    params = {"w": torch.tensor([3.0, -2.0, 5.0]),
              "m": torch.ones((4, 6)) * 2.0}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["m"] ** 2)

    l0 = float(loss(params))
    for _ in range(60):
        ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        g = dict(zip(ps, torch.autograd.grad(loss(ps), list(ps.values()))))
        upd, state = opt.update(g, state, params)
        params = {k: params[k] + upd[k] for k in params}
    assert float(loss(params)) < 0.05 * l0
