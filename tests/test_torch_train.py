"""The port's training path against the JAX package, on the CPU: the
reverse ssm_scan and every family's loss and gradients.

Inputs come from seeded numpy draws (the JAX package's ``SyntheticLMData``)
and weights from the JAX package's ``init_params``, loaded into the port
with ``params_from_reference``, so both packages compute on the same
numbers.  The JAX side is ``jax.value_and_grad(repro.models.transformer
.loss_fn)`` without a mesh; the port runs its plain versions here (the
reverse-scan loop instead of the CUDA kernel, which
tests/test_torch_cuda.py holds to that loop on the card).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jscan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.ssm_scan import (ssm_scan,  # noqa: E402
                                          ssm_scan_bwd_ref, ssm_scan_ref)
from repro_torch.models import transformer as T  # noqa: E402

JAMBA = "jamba-1.5-large-398b"
FAMILIES = [JAMBA, "qwen2-7b", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "whisper-small", "qwen2-vl-72b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Smoke-size tensors: one intra-op thread is the faster, and keeps the
    test's time steady when other processes load the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol):
    """rtol=atol=tol, atol shrunk to tol x max|want| where that is below 1
    (tests/test_torch_lm.py's rule): a gradient of 1e-12 is compared at
    its own scale."""
    want = _np(want)
    scale = min(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


# ------------------------------------------------------- the reverse scan
def _scan_inputs(b, s, f, seed):
    rng = np.random.default_rng(seed)
    return (-rng.uniform(0, 2, (b, s, f)).astype(np.float32),
            rng.normal(size=(b, s, f)).astype(np.float32),
            rng.normal(size=(b, f)).astype(np.float32),
            rng.normal(size=(b, s, f)).astype(np.float32))


@pytest.mark.parametrize("b,s,f", [(1, 1, 1), (2, 3, 7), (3, 17, 300),
                                   (2, 64, 33)])
def test_scan_bwd_ref_matches_autograd_and_jax_vjp(b, s, f):
    la, bx, s0, g = _scan_inputs(b, s, f, seed=b * 1000 + s * 10 + f)
    tla, tbx, ts0, tg = map(torch.from_numpy, (la, bx, s0, g))
    got = ssm_scan_bwd_ref(tla, ssm_scan_ref(tla, tbx, ts0), ts0, tg)
    # autograd through the plain forward loop
    ins = [x.clone().requires_grad_(True) for x in (tla, tbx, ts0)]
    ssm_scan_ref(*ins).backward(tg)
    # the JAX package's scan, differentiated by JAX
    _, vjp = jax.vjp(jscan, jnp.asarray(la), jnp.asarray(bx),
                     jnp.asarray(s0))
    for x, a, j in zip(got, ins, vjp(jnp.asarray(g))):
        assert x.shape == a.shape and x.dtype == torch.float32
        _close(x, a.grad, 1e-5)
        _close(x, j, 1e-5)
    assert float(got[2].abs().max()) > 0          # ds0 is not dropped


def test_ssm_scan_is_differentiable_through_its_reverse_scan():
    la, bx, s0, g = (torch.from_numpy(x) for x in _scan_inputs(2, 9, 5, 3))
    ins = [x.clone().requires_grad_(True) for x in (la, bx, s0)]
    out = ssm_scan(*ins)
    assert type(out.grad_fn).__name__ == "SSMScanBackward"
    out.backward(g)
    want = ssm_scan_bwd_ref(la, ssm_scan_ref(la, bx, s0), s0, g)
    for x, w in zip(ins, want):
        assert torch.equal(x.grad, w)
    with torch.no_grad():
        assert ssm_scan(la, bx, s0).grad_fn is None
        assert torch.equal(ssm_scan(la, bx, s0), ssm_scan_ref(la, bx, s0))


# -------------------------------------------------- families: loss, grads
def _setup(arch, b=2, s=16, step=0):
    """(port config, JAX config, JAX params, port model, numpy batch)."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = JT.init_params(jcfg, 0)
    model = T.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")
    data = JData(vocab=cfg.vocab, batch=b, seq=s, seed=3,
                 input_mode=cfg.input_mode, d_model=cfg.d_model,
                 encoder=cfg.encoder_layers > 0, mrope=cfg.pos == "mrope")
    return cfg, jcfg, jp, model, data.batch_at(step)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(model, batch):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss, metrics = T.loss_fn(model, _torch_batch(batch))
    loss.backward()
    return loss, metrics


def _walk(ref, model_tree, path=""):
    for k, v in ref.items():
        if isinstance(v, dict):
            yield from _walk(v, model_tree[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", v, model_tree[k], model_tree


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    cfg, jcfg, jp, model, batch = _setup(arch)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, metrics = _grads(model, batch)
    _close(loss, jloss, 1e-5)
    for k in ("nll", "aux", "tokens"):
        _close(metrics[k], jm[k], 1e-5)
    n = 0
    for path, want, got, sibs in _walk(jg, model.params):
        g = got.grad
        assert g is not None and g.shape == got.shape, path
        if cfg.pos not in ("rope", "mrope") and path.endswith("mixer/bk"):
            # A bias added to every key shifts each query's logits by one
            # constant, which softmax removes: the exact gradient is 0 and
            # both packages hold float32 noise, held to the scale of the
            # key projection's gradient.
            tiny = 1e-6 * float(np.abs(_leaf(jg, path[:-2] + "wk")).max())
            assert float(g.abs().max()) <= tiny, path
            assert float(np.abs(np.asarray(want)).max()) <= tiny, path
        else:
            _close(g, want, 1e-4)
        n += 1
    assert n == sum(1 for _ in model.parameters())


@pytest.mark.parametrize("arch", [JAMBA, "whisper-small"])
def test_remat_changes_no_gradient(arch, monkeypatch):
    """Per-sub-layer recomputation (and the encoder's) gives the same loss
    and gradients, bit for bit, as keeping every activation."""
    *_, model, batch = _setup(arch)
    calls = []

    def plain(fn, *args, use_reentrant, **kw):
        calls.append(fn)
        return fn(*args, **kw)

    loss, _ = _grads(model, batch)
    with_remat = [p.grad.clone() for p in model.parameters()]
    monkeypatch.setattr(T, "checkpoint", plain)     # keep every activation
    loss2, _ = _grads(model, batch)
    assert len(calls) == model.cfg.n_layers + model.cfg.encoder_layers
    assert torch.equal(loss, loss2)
    for a, p in zip(with_remat, model.parameters()):
        assert torch.equal(a, p.grad)


def test_serving_params_stay_frozen():
    """The parameters are frozen until the train path asks for gradients,
    so serving builds no graph."""
    *_, model, batch = _setup("qwen2-7b")
    assert not any(p.requires_grad for p in model.parameters())
    hidden, _, _ = model(_torch_batch(batch), mode="train")
    assert hidden.grad_fn is None
