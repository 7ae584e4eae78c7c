"""The port's LM serving slice against the JAX package, on the CPU.

Inputs come from seeded numpy draws and weights from the JAX package's
``init_params``, loaded into the port with ``params_from_reference``, so
both packages compute on the same numbers.  The port runs its plain
versions here (the ssm_scan loop instead of the CUDA kernel);
tests/test_torch_cuda.py holds the kernel to that loop on the card.
Unless a test says otherwise the model is the smoke-size Jamba with its
experts (f32, 8 layers, d_model 64).  tests/test_torch_families.py holds
the MoE, RWKV, encoder-decoder and embeds-input pieces on their own, and
the two families that take more than tokens (whisper, qwen2-vl).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels.ssm_scan.kernel import ssm_scan_pallas  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jssm_ref  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.ssm import mamba_mix as jmamba_mix  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.launch.steps import prefill_step, serve_step  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.ssm import mamba_mix  # noqa: E402

JAMBA = "jamba-1.5-large-398b"
# the decoder-only families fed by tokens alone (whisper needs encoder
# frames and qwen2-vl embeddings: tests/test_torch_families.py)
SERVED = [JAMBA, "gemma2-2b", "gemma-7b", "granite-34b", "qwen2-7b",
          "granite-moe-1b-a400m", "llama4-scout-17b-a16e", "rwkv6-1.6b"]


def _cfgs(arch, smoke=True, **over):
    """(port config, JAX config) of one arch."""
    port = get_smoke_config(arch) if smoke else get_config(arch)
    ref = jget_smoke(arch) if smoke else jget_config(arch)
    return port.scaled(**over), ref.scaled(**over)


def _models(arch, seed=0, **over):
    cfg, jcfg = _cfgs(arch, **over)
    jp = JT.init_params(jcfg, seed)
    model = T.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return cfg, jcfg, jp, model


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol):
    """rtol=atol=tol, with atol shrunk to tol x max|want| where that is
    below 1: a Mamba state or cache of 1e-7 is compared at its own scale,
    never more loosely than at rtol=atol=tol."""
    want = _np(want)
    scale = min(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list_archs())
def test_configs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(jcfg.smoke())
    assert cfg.scan_period() == jcfg.scan_period()
    assert [dataclasses.asdict(s) for s in cfg.layer_specs()] == \
        [dataclasses.asdict(s) for s in jcfg.layer_specs()]
    assert cfg.param_count() == jcfg.param_count()
    for name, cell in shapes.SHAPES.items():
        assert dataclasses.asdict(cell) == \
            dataclasses.asdict(jshapes.SHAPES[name])
        assert shapes.cell_is_applicable(cfg, name) == \
            jshapes.cell_is_applicable(jcfg, name)


# ------------------------------------------------------------ ssm_scan
@pytest.mark.parametrize("b,s,f,sc,ft", [(1, 5, 3, 4, 128),
                                         (2, 300, 700, 64, 256),
                                         (3, 128, 512, 128, 512)])
def test_ssm_scan_ref_matches_reference(b, s, f, sc, ft):
    """Draws and tolerance of tests/test_kernels.py's ssm_scan test."""
    rng = np.random.default_rng(7)
    la = -np.abs(rng.normal(0.3, 0.5, (b, s, f))).astype(np.float32)
    bx = rng.normal(0, 1, (b, s, f)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, f)).astype(np.float32)
    pallas = ssm_scan_pallas(jnp.asarray(la), jnp.asarray(bx),
                             jnp.asarray(s0), s_chunk=sc, f_tile=ft,
                             interpret=True)
    jref = jssm_ref(jnp.asarray(la), jnp.asarray(bx), jnp.asarray(s0))
    args = [torch.from_numpy(a) for a in (la, bx, s0)]
    n0 = ssm_scan.launches
    got = ssm_scan(*args)                     # CPU tensors: the plain loop
    assert ssm_scan.launches == n0
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, f)
    assert torch.equal(got, ssm_scan_ref(*args))
    _close(got, pallas, 1e-5)
    _close(got, jref, 1e-5)


def test_ssm_scan_raises_on_other_devices():
    """A device with neither the kernel nor the plain loop is refused
    (``meta``, the dry run's shape rule, is tested in
    tests/test_torch_dryrun.py; this build has no other device, so a
    stand-in carries one)."""
    class Elsewhere:
        device = torch.device("xpu")

    t = Elsewhere()
    with pytest.raises(ValueError, match="unsupported device"):
        ssm_scan(t, t, t)


# -------------------------------------------------------------- layers
def _layer_cases():
    """name -> fn(module, tensor maker) over fixed numpy draws."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (2, 7, 4, 16)).astype(np.float32)
    x3 = x.reshape(2, 7, 64)
    sc, bi = (rng.normal(0, 0.5, 64).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, 50, (2, 7)).astype(np.int32)
    pos3 = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    return {
        "rmsnorm": lambda m, t: m.rmsnorm(t(x3), t(sc)),
        "layernorm": lambda m, t: m.layernorm(t(x3), t(sc), t(bi)),
        "norm": lambda m, t: m.norm(t(x3), {"scale": t(sc), "bias": t(bi)},
                                    "layernorm"),
        "softcap": lambda m, t: m.softcap(t(x3) * 40.0, 30.0),
        "rope": lambda m, t: m.apply_rope(t(x), t(pos), 10_000.0),
        "mrope": lambda m, t: m.apply_rope(t(x), t(pos3), 1e6, (2, 3, 3)),
        "group_rmsnorm": lambda m, t: m.group_rmsnorm(t(x), t(sc[:16])),
        **{f"act_{k}": (lambda k: lambda m, t: m.activation(t(x3), k))(k)
           for k in ("silu", "gelu", "relu", "relu_sq")},
    }


@pytest.mark.parametrize("name", list(_layer_cases()))
def test_layers_match_reference(name):
    fn = _layer_cases()[name]
    _close(fn(L, torch.from_numpy), fn(JL, jnp.asarray), 1e-5)


# --------------------------------------------------------------- mamba
@pytest.mark.parametrize("scan_impl", ["assoc", "unroll"])
def test_mamba_mix_matches_reference(scan_impl):
    cfg, jcfg, jp, model = _models(JAMBA, seed=4)
    p = model.params["dec"].select(0)["sub0"]["mixer"]
    jpm = jax.tree.map(lambda x: x[0], jp["dec"]["sub0"]["mixer"])
    b, s, d = 2, 19, cfg.d_model
    m = cfg.mamba
    di = m.d_inner(d)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.5, (b, s, d)).astype(np.float32)
    s0 = rng.normal(0, 0.5, (b, di, m.d_state)).astype(np.float32)
    c0 = rng.normal(0, 0.5, (b, m.d_conv - 1, di)).astype(np.float32)
    # chunk 8 pads 19 steps to 24 in the JAX scan; the port never pads
    jy, (js, jc) = jmamba_mix(jpm, jnp.asarray(x), jcfg,
                              (jnp.asarray(s0), jnp.asarray(c0)), chunk=8,
                              scan_impl=scan_impl)
    y, (st, conv) = mamba_mix(p, torch.from_numpy(x), cfg,
                              (torch.from_numpy(s0), torch.from_numpy(c0)))
    for got, want in ((y, jy), (st, js), (conv, jc)):
        assert tuple(got.shape) == want.shape
        _close(got, want, 2e-4)


# ----------------------------------------------------------- attention
@pytest.mark.parametrize("window,cap", [(None, None), (8, None),
                                        (None, 30.0)])
def test_attend_dense_and_chunked_match_reference(window, cap):
    rng = np.random.default_rng(2)
    b, s, h, kv, hd = 2, 50, 4, 2, 16
    q, k, v = (rng.normal(0, 1, (b, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    rank = np.arange(s, dtype=np.int32)[None]
    jrank, trank = jnp.asarray(rank), torch.from_numpy(rank)
    scale = hd ** -0.5
    jbias = JA._mask_bias(jrank, jrank, True, window)
    tbias = A._mask_bias(trank, trank, True, window)
    _close(tbias, jbias, 0)
    dense = A._attend_dense(tq, tk, tv, tbias, scale, cap)
    _close(dense, JA._attend_dense(jq, jk, jv, jbias, scale, cap), 2e-5)
    chunked = A._attend_chunked(tq, tk, tv, trank, trank, True, window,
                                scale, cap, chunk=16)
    _close(chunked, JA._attend_chunked(jq, jk, jv, jrank, jrank, True,
                                       window, scale, cap, chunk=16), 2e-5)
    _close(chunked, dense, 2e-5)


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("arch", SERVED)
def test_forward_and_logits_match_reference(arch):
    cfg, jcfg, jp, model = _models(arch)
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 17))
    jh, jaux, _ = JT.forward(jcfg, jp,
                             {"tokens": jnp.asarray(tok, jnp.int32)},
                             mode="train")
    with torch.inference_mode():
        h, aux, cache = model({"tokens": torch.from_numpy(tok)})
        logits = model.logits_from_hidden(h)
    assert cache is None and (float(aux) > 0) == (cfg.moe is not None)
    _close(aux, jaux, 1e-4)
    _close(h, jh, 1e-4)
    _close(logits, JT.logits_from_hidden(jcfg, jp, jh), 1e-4)


def _prefill_decode(model, cfg, tok, s_max):
    """The port's prefill of tok[:, :-1], then one decode of tok[:, -1]
    (hidden states, cache)."""
    b, s = tok.shape
    t = torch.from_numpy(tok)
    cache = T.init_cache(cfg, b, s_max, device="cpu")
    with torch.inference_mode():
        h_pre, _, cache = model({"tokens": t[:, :-1]}, mode="prefill",
                                cache=cache)
        h_dec, _, cache = model(
            {"tokens": t[:, -1:], "cache_index": s - 1,
             "positions": torch.full((b, 1), s - 1, dtype=torch.int32)},
            mode="decode", cache=cache)
    return h_pre, h_dec, cache


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_matches_own_forward(arch):
    """Tolerances of tests/test_archs_smoke.py's prefill/decode test, and
    its drop-free capacity for MoE (a capacity cut depends on the number
    of tokens routed together)."""
    moe = get_smoke_config(arch).moe
    over = {} if moe is None else {"moe": dataclasses.replace(
        moe, capacity_factor=float(moe.num_experts))}
    cfg, _, _, model = _models(arch, **over)
    b, s = 2, 17
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (b, s))
    with torch.inference_mode():
        h_ref, _, _ = model({"tokens": torch.from_numpy(tok)})
    h_pre, h_dec, _ = _prefill_decode(model, cfg, tok, s + 3)
    _close(h_pre, h_ref[:, :s - 1], 2e-3)
    _close(h_dec[:, 0], h_ref[:, s - 1], 5e-3)


@pytest.mark.parametrize("threshold", [8192, 8])
def test_prefill_decode_and_serve_step_match_reference(threshold):
    """Prefill and one decode against the JAX forward in the same modes,
    dense attention or (threshold 8) the chunked online softmax over the
    cache; then prefill_step + serve_step's greedy token against JAX's
    decode logits' argmax."""
    cfg, jcfg, jp, model = _models(JAMBA, attn_chunk_threshold=threshold)
    b, s, s_max = 2, 17, 24
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (b, s))
    jtok = jnp.asarray(tok, jnp.int32)
    jcache = JT.init_cache(jcfg, b, s_max)
    jh_pre, _, jcache = JT.forward(jcfg, jp, {"tokens": jtok[:, :-1]},
                                   mode="prefill", cache=jcache)
    jh_dec, _, jcache = JT.forward(
        jcfg, jp, {"tokens": jtok[:, -1:], "cache_index": jnp.int32(s - 1),
                   "positions": jnp.full((b, 1), s - 1, jnp.int32)},
        mode="decode", cache=jcache)
    h_pre, h_dec, cache = _prefill_decode(model, cfg, tok, s_max)
    _close(h_pre, jh_pre, 1e-4)
    _close(h_dec, jh_dec, 1e-4)
    for sub, leaves in jcache.items():
        for name, want in leaves.items():
            _close(cache[sub][name], want, 1e-4)

    cache = T.init_cache(cfg, b, s_max, device="cpu")
    t = torch.from_numpy(tok)
    last, cache = prefill_step(model, {"tokens": t[:, :-1]}, cache)
    _close(last, JT.logits_from_hidden(jcfg, jp, jh_pre[:, -1:]), 1e-4)
    nxt, cache = serve_step(model, cache, {"tokens": t[:, -1:],
                                           "cache_index": s - 1})
    want = jnp.argmax(JT.logits_from_hidden(jcfg, jp, jh_dec), axis=-1)
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (b, 1)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want))


def test_serve_step_takes_its_rope_position_from_the_cache_index():
    """A RoPE model's decode token without ``positions``, against the JAX
    decode given the position explicitly."""
    cfg, jcfg, jp, model = _models("qwen2-7b")
    b, s, s_max = 2, 9, 12
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (b, s))
    jtok = jnp.asarray(tok, jnp.int32)
    jcache = JT.init_cache(jcfg, b, s_max)
    _, _, jcache = JT.forward(jcfg, jp, {"tokens": jtok[:, :-1]},
                              mode="prefill", cache=jcache)
    jh, _, _ = JT.forward(
        jcfg, jp, {"tokens": jtok[:, -1:], "cache_index": jnp.int32(s - 1),
                   "positions": jnp.full((b, 1), s - 1, jnp.int32)},
        mode="decode", cache=jcache)
    want = jnp.argmax(JT.logits_from_hidden(jcfg, jp, jh), axis=-1)
    t = torch.from_numpy(tok)
    cache = T.init_cache(cfg, b, s_max, device="cpu")
    _, cache = prefill_step(model, {"tokens": t[:, :-1]}, cache)
    nxt, _ = serve_step(model, cache, {"tokens": t[:, -1:],
                                       "cache_index": s - 1})
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="do not fit"):
        prefill_step(model, {"tokens": t}, T.init_cache(cfg, b, 4, "cpu"))


def test_prefill_step_resets_a_used_cache():
    cfg, _, _, model = _models(JAMBA)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 9)))
    fresh = T.init_cache(cfg, 2, 12, device="cpu")
    want, fresh = prefill_step(model, {"tokens": tok}, fresh)
    used = T.init_cache(cfg, 2, 12, device="cpu")
    for sub in used.values():
        for t in sub.values():
            t.fill_(0.5)
    got, used = prefill_step(model, {"tokens": tok}, used)
    assert torch.equal(got, want)
    for sub in fresh:
        for name in fresh[sub]:
            assert torch.equal(used[sub][name], fresh[sub][name])


# ----------------------------------------------------- template and init
@pytest.mark.parametrize("arch,n_layers", [(a, None) for a in list_archs()]
                         + [(JAMBA, 8), (JAMBA, 2)])
def test_param_count_matches_config(arch, n_layers):
    """The full config, counted from the template without allocating."""
    over = {} if n_layers is None else {"n_layers": n_layers}
    cfg, jcfg = _cfgs(arch, smoke=False, **over)

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v.shape)
                   for v in tree.values())

    n, analytic = count(T.param_template(cfg)), cfg.param_count()
    assert abs(n - analytic) / analytic < 0.03, (arch, n, analytic)
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(JT.abstract_params(jcfg)))
    assert n == want


def test_init_params_follows_the_reference_init_kinds():
    cfg, jcfg = _cfgs(JAMBA)
    got = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(np.asarray, JT.init_params(jcfg, 0))
    mixer, jmixer = got["dec"]["sub0"]["mixer"], want["dec"]["sub0"]["mixer"]
    for name in ("conv_b", "dt_bias", "A_log", "D"):   # deterministic kinds
        _close(mixer[name], jmixer[name], 1e-7)
    for name, std in (("in_proj", 0.02), ("out_proj", 0.02)):
        assert abs(float(mixer[name].std()) - std) < 0.1 * std
    tok = got["embed"]["tok"]
    assert abs(float(tok.std()) - cfg.d_model ** -0.5) < 0.05 * tok.std()
    again = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"]["tok"], tok)

    # RWKV's "small" kind: 0.006, as the JAX package draws it
    cfg, jcfg = _cfgs("rwkv6-1.6b", d_model=256)
    got = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(np.asarray, JT.init_params(jcfg, 0))
    mixer, jmixer = got["dec"]["sub0"]["mixer"], want["dec"]["sub0"]["mixer"]
    for name in ("mix_a", "mix_b", "dec_a", "dec_b", "u", "wr", "wo"):
        std, jstd = float(mixer[name].std()), float(jmixer[name].std())
        assert abs(std - jstd) < 0.1 * jstd, (name, std, jstd)
    assert abs(float(mixer["mix_a"].std()) - 0.006) < 0.1 * 0.006
    for name in ("mu_x", "mu", "w0", "ln_x"):           # zeros and ones
        _close(mixer[name], jmixer[name], 0)


def test_params_from_reference_rejects_a_wrong_tree():
    cfg, jcfg = _cfgs(JAMBA)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, 0))
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm/scale"):
        T.params_from_reference(cfg, tree, device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        T.params_from_reference(cfg, tree, device="cpu")


def _leaves(tree, path=""):
    """{path: leaf} of a nested dict whose leaves are P specs or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{path}/{k}"))
        else:
            out[f"{path}/{k}"] = v
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_template_init_and_cache_match_reference(arch):
    """Every family: the parameter template (shapes, axes, init kinds) is
    the JAX package's; init_params realises it in the config's dtype with
    the deterministic kinds equal to JAX's; init_cache (with s_enc for the
    encoder-decoder) has JAX's leaves, shapes and dtypes; and a model
    builds from the JAX package's parameters."""
    cfg, jcfg = _cfgs(arch)
    want = _leaves(JT.param_template(jcfg))
    got = _leaves(T.param_template(cfg))
    assert got.keys() == want.keys()
    for k, p in got.items():
        assert tuple(p) == tuple(want[k]), k

    params = _leaves(T.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu"))
    jtree = jax.tree.map(np.asarray, JT.init_params(jcfg, 0))
    jparams = _leaves(jtree)
    assert params.keys() == jparams.keys()
    for k, t in params.items():
        assert tuple(t.shape) == jparams[k].shape and t.dtype == \
            torch.float32, k
        if got[k].init in ("zeros", "ones", "alog", "dtbias"):
            _close(t, jparams[k], 1e-7)

    s_enc = 5 if cfg.encoder_layers else None
    cache = _leaves(T.init_cache(cfg, 2, 8, "cpu", s_enc=s_enc))
    jcache = _leaves(JT.init_cache(jcfg, 2, 8, s_enc))
    assert cache.keys() == jcache.keys()
    for k, t in cache.items():
        assert tuple(t.shape) == jcache[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(jcache[k].dtype), k
        assert not t.any()
    model = T.params_from_reference(cfg, jtree, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        math.prod(p.shape) for p in got.values())


def test_model_and_cache_default_to_cuda_and_raise_without_it():
    cfg, _ = _cfgs(JAMBA)
    if torch.cuda.is_available():
        assert T.Transformer(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="Transformer runs on CUDA"):
        T.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 1, 8)
