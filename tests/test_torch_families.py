"""The port's MoE, RWKV6, encoder-decoder and embeds-input families against
the JAX package, on the CPU.

Inputs come from seeded numpy draws, and weights from the JAX package's
``init_params`` (loaded with ``params_from_reference``) or, for the mixers
alone, from seeded draws wider than the init, so that both packages
compute on the same numbers.  The models are the smoke configs (f32,
d_model 64); Jamba keeps its experts and its scan is the plain loop here.
Tolerance: 1e-4, scaled as tests/test_torch_lm.py's ``_close`` scales it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.steps import prefill_step, serve_step  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import mlp as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

FAMILIES = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e",
            "jamba-1.5-large-398b", "rwkv6-1.6b", "whisper-small",
            "qwen2-vl-72b"]
TOL = 1e-4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    """rtol=atol=tol, atol shrunk to tol x max|want| where that is below 1
    (tests/test_torch_lm.py's rule)."""
    want = _np(want)
    scale = min(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _cfgs(arch, **over):
    return get_smoke_config(arch).scaled(**over), jget_smoke(arch).scaled(
        **over)


def _models(arch, seed=0, **over):
    cfg, jcfg = _cfgs(arch, **over)
    jp = JT.init_params(jcfg, seed)
    model = T.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return cfg, jcfg, jp, model


def _first(tree):
    """Group 0 of a stacked JAX parameter subtree, as numpy."""
    return jax.tree.map(lambda x: np.asarray(x[0]), tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# ----------------------------------------------------------------- MoE
def _moe_case(top_k, shared):
    arch = "llama4-scout-17b-a16e" if shared else "granite-moe-1b-a400m"
    return arch, max(get_smoke_config(arch).moe.num_experts, top_k)


def _jax_slots(choice, cap, n_exp):
    """The JAX package's dispatch in numpy: (slot, keep) in sorted order."""
    flat_e = choice.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    se = flat_e[order]
    start = np.searchsorted(se, np.arange(n_exp), side="left")
    pos = np.arange(flat_e.size) - start[se]
    keep = pos < cap
    return np.where(keep, se * cap + pos, n_exp * cap), keep


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("top_k,shared,cf", [
    (1, False, 0.5), (2, False, 0.5), (8, False, 0.5), (2, False, 1.25),
    (8, False, 8.0), (1, True, 0.5), (1, True, 1.25)])
def test_moe_ffn_matches_reference(grouped, top_k, shared, cf):
    arch, n_exp = _moe_case(top_k, shared)
    over = {"moe_grouped_dispatch": grouped}
    base = get_smoke_config(arch).moe
    moe = dataclasses.replace(base, num_experts=n_exp, top_k=top_k,
                              capacity_factor=cf)
    cfg, jcfg, jp, model = _models(arch, seed=3, moe=moe, **over)
    sub = next(i for i, sp in enumerate(cfg.layer_specs()[
        :cfg.scan_period()]) if sp.mlp == "moe")
    jmp = _first(jp["dec"][f"sub{sub}"]["mlp"])
    rng = np.random.default_rng(top_k)
    b, s, d = 3, 10, cfg.d_model
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    jout, jaux = JMOE.moe_ffn(_j(jmp), jnp.asarray(x), jcfg)
    out, aux = MOE.moe_ffn(_t(jmp), torch.from_numpy(x), cfg)
    assert tuple(out.shape) == (b, s, d) and aux.dtype == torch.float32
    _close(out, jout)
    _close(aux, jaux)

    # routing and dropped slots of one group, against the JAX package's
    xt = x[:1].reshape(-1, d) if grouped else x.reshape(-1, d)
    t = xt.shape[0]
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(jmp["router"]), -1)
    _, jchoice = jax.lax.top_k(jprobs, top_k)
    gate, choice, probs = MOE.route(_t(jmp), torch.from_numpy(xt), cfg)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice))
    _close(probs, jprobs)
    cap = MOE.capacity(t, cfg)
    assert cap == int(max(1, round(t * top_k * cf / n_exp)))
    slot, keep, _, _ = MOE.dispatch(choice, cap, n_exp)
    want_slot, want_keep = _jax_slots(np.asarray(jchoice), cap, n_exp)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf < 1:
        assert int(keep.sum()) < t * top_k          # tokens were dropped
    if cf >= n_exp:
        assert bool(keep.all())


def test_moe_capacity_rounds_half_to_even():
    cfg = get_smoke_config("granite-moe-1b-a400m")
    moe = dataclasses.replace(cfg.moe, num_experts=4, top_k=1,
                              capacity_factor=1.0)
    cfg = cfg.scaled(moe=moe)
    # t*k*cf/E = 2.5 and 3.5: Python's round gives 2 and 4
    assert MOE.capacity(10, cfg) == 2 and MOE.capacity(14, cfg) == 4
    assert MOE.capacity(1, cfg) == 1


def test_moe_top_k_ties_go_to_the_lower_expert():
    cfg = get_smoke_config("granite-moe-1b-a400m")
    d, e = cfg.d_model, cfg.moe.num_experts
    router = np.zeros((d, e), np.float32)          # every expert ties
    xt = np.random.default_rng(0).normal(0, 1, (5, d)).astype(np.float32)
    _, choice, _ = MOE.route({"router": torch.from_numpy(router)},
                             torch.from_numpy(xt), cfg)
    _, jchoice = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xt @ router), -1),
                               cfg.moe.top_k)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice))


# ---------------------------------------------------------------- RWKV
def _rwkv_params(cfg, jp, seed):
    """The time-mix and channel-mix parameters of layer 0, redrawn wider
    than the init (mixes, decays and bonus away from 0)."""
    rng = np.random.default_rng(seed)
    mix = {k: (rng.normal(0, 0.3 if k in ("w0", "mu", "mu_x") else 0.15,
                          v.shape).astype(np.float32))
           for k, v in _first(jp["dec"]["sub0"]["mixer"]).items()}
    mix["ln_x"] = 1.0 + mix["ln_x"]
    ffn = {k: rng.normal(0, 0.15, v.shape).astype(np.float32)
           for k, v in _first(jp["dec"]["sub0"]["mlp"]).items()}
    return mix, ffn


def _rwkv_state(cfg, b, seed, zero=False):
    rng = np.random.default_rng(seed)
    hd = cfg.rwkv.head_dim
    h = cfg.d_model // hd
    wkv = rng.normal(0, 0.5, (b, h, hd, hd)).astype(np.float32)
    shift = rng.normal(0, 1, (b, cfg.d_model)).astype(np.float32)
    if zero:
        wkv, shift = np.zeros_like(wkv), np.zeros_like(shift)
    return wkv, shift


@pytest.mark.parametrize("s,chunk,carried", [(70, 64, True), (70, 64, False),
                                             (9, 1, True), (1, 1, True),
                                             (33, 16, True)])
def test_rwkv_time_mix_matches_reference(s, chunk, carried):
    cfg, jcfg, jp, _ = _models("rwkv6-1.6b")
    mix, _ = _rwkv_params(cfg, jp, seed=s)
    b = 2
    x = np.random.default_rng(1).normal(0, 1, (b, s, cfg.d_model)).astype(
        np.float32)
    state = _rwkv_state(cfg, b, seed=2, zero=not carried)
    jy, (jS, jsh) = JR.rwkv_time_mix(_j(mix), jnp.asarray(x), jcfg,
                                     _j(state), chunk=chunk)
    y, (S, sh) = R.rwkv_time_mix(_t(mix), torch.from_numpy(x), cfg,
                                 _t(state), chunk=chunk)
    assert S.dtype == torch.float32 and tuple(S.shape) == jS.shape
    _close(y, jy)
    _close(S, jS)
    _close(sh, jsh, 0)


def test_rwkv_chunked_equals_step_recurrence():
    """The chunk-64 form over 70 tokens against 70 single-token steps."""
    cfg, _, jp, _ = _models("rwkv6-1.6b")
    mix, _ = _rwkv_params(cfg, jp, seed=5)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 70, cfg.d_model)).astype(np.float32))
    state = _t(_rwkv_state(cfg, 2, seed=4))
    y, (S, _) = R.rwkv_time_mix(_t(mix), x, cfg, state)
    st, ys = state, []
    for i in range(x.shape[1]):
        yi, st = R.rwkv_time_mix_step(_t(mix), x[:, i:i + 1], cfg, st)
        ys.append(yi)
    _close(torch.cat(ys, 1), y, 2e-4)
    _close(st[0], S, 2e-4)


def test_rwkv_channel_mix_matches_reference():
    cfg, jcfg, jp, _ = _models("rwkv6-1.6b")
    _, ffn = _rwkv_params(cfg, jp, seed=6)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 13, cfg.d_model)).astype(np.float32)
    shift = rng.normal(0, 1, (2, cfg.d_model)).astype(np.float32)
    jout, jsh = JM.rwkv_channel_mix(_j(ffn), jnp.asarray(x),
                                    jnp.asarray(shift), jcfg)
    out, sh = M.rwkv_channel_mix(_t(ffn), torch.from_numpy(x),
                                 torch.from_numpy(shift), cfg)
    _close(out, jout)
    _close(sh, jsh, 0)


def test_rwkv_bf16_cache_holds_the_rounded_state():
    """The cache holds the wkv state in the model's dtype between calls,
    as the JAX package casts it: a bf16 prefill, then one decode, within
    bf16 rounding of JAX's; every cache leaf in bf16 as JAX's; and layer
    0's cached state is its float32 state rounded to bf16, not that
    state."""
    cfg, jcfg, jp, model = _models("rwkv6-1.6b", dtype="bfloat16")
    b, s, s_max = 2, 20, 24
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (b, s))
    jtok = jnp.asarray(tok, jnp.int32)
    jcache = JT.init_cache(jcfg, b, s_max)
    _, _, jcache = JT.forward(jcfg, jp, {"tokens": jtok[:, :-1]},
                              mode="prefill", cache=jcache)
    jh, _, _ = JT.forward(jcfg, jp, {
        "tokens": jtok[:, -1:], "cache_index": jnp.int32(s - 1),
        "positions": jnp.full((b, 1), s - 1, jnp.int32)},
        mode="decode", cache=jcache)
    t = torch.from_numpy(tok)
    cache = T.init_cache(cfg, b, s_max, "cpu")
    with torch.inference_mode():
        _, _, cache = model({"tokens": t[:, :-1]}, mode="prefill",
                            cache=cache)
        for sub, leaves in jcache.items():
            for name, want in leaves.items():
                assert cache[sub][name].dtype == torch.bfloat16
                assert want.dtype == jnp.bfloat16
                _close(cache[sub][name].float(),
                       np.asarray(want.astype(jnp.float32)), 2e-2)
        wkv0 = cache["sub0"]["wkv"][0].clone()
        h, _, _ = model({"tokens": t[:, -1:], "cache_index": s - 1},
                        mode="decode", cache=cache)
        _close(h.float(), np.asarray(jh.astype(jnp.float32)), 2e-2)

        p0 = model.params["dec"].select(0)["sub0"]
        x0 = T.norm(model.params["embed"]["tok"][t[:, :-1]], p0["ln1"],
                    cfg.norm)
        _, (S, _) = R.rwkv_time_mix(p0["mixer"], x0, cfg, T._zero_state(
            cfg, cfg.layer_specs()[0], x0))
    assert S.dtype == torch.float32
    assert torch.equal(wkv0, S.to(torch.bfloat16))
    assert not torch.equal(S.to(torch.bfloat16).float(), S)


# ------------------------------------------------------ cross-attention
def test_cross_attention_matches_reference():
    """Whisper's cross block: keys from the encoder states (prefill,
    written into the cross cache in place), then read from that cache
    (decode); and the encoder's bidirectional self-attention."""
    cfg, jcfg, jp, model = _models("whisper-small")
    spec = cfg.layer_specs()[0]
    jx = _first(jp["dec"]["sub0"]["xattn"])
    assert "bk" not in jx                        # no bias on the cross KV
    rng = np.random.default_rng(9)
    b, s, s_enc, d = 2, 6, 11, cfg.d_model
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    enc = rng.normal(0, 1, (b, s_enc, d)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jout, jnc = JA.attention(_j(jx), jnp.asarray(x), jcfg, spec,
                             jnp.asarray(pos), causal=False,
                             kv_source=jnp.asarray(enc))
    kv = cfg.n_kv_heads, cfg.resolved_head_dim
    xc = {n: torch.zeros((b, s_enc) + kv) for n in ("xk", "xv")}
    out = A.attention(_t(jx), torch.from_numpy(x), cfg, spec,
                      torch.from_numpy(pos), causal=False, cache=xc,
                      kv_source=torch.from_numpy(enc))
    _close(out, jout)
    for n in ("xk", "xv"):
        _close(xc[n], jnc[n])
    no_cache = A.attention(_t(jx), torch.from_numpy(x), cfg, spec,
                           torch.from_numpy(pos), causal=False,
                           kv_source=torch.from_numpy(enc))
    _close(no_cache, jout)

    x1 = x[:, -1:]
    jdec, _ = JA.attention(_j(jx), jnp.asarray(x1), jcfg, spec,
                           jnp.asarray(pos[:, -1:]), causal=False,
                           cache={"xk": jnc["xk"], "xv": jnc["xv"]})
    dec = A.attention(_t(jx), torch.from_numpy(x1), cfg, spec,
                      torch.from_numpy(pos[:, -1:]), causal=False, cache=xc)
    _close(dec, jdec)

    je = _first(jp["enc"]["sub0"]["mixer"])
    jenc, _ = JA.attention(_j(je), jnp.asarray(enc), jcfg, spec,
                           jnp.asarray(np.broadcast_to(
                               np.arange(s_enc, dtype=np.int32),
                               (b, s_enc))), causal=False)
    got = A.attention(_t(je), torch.from_numpy(enc), cfg, spec,
                      torch.arange(s_enc, dtype=torch.int32)[None].expand(
                          b, s_enc), causal=False)
    _close(got, jenc)
    with pytest.raises(ValueError, match="do not fit"):
        A.attention(_t(jx), torch.from_numpy(x), cfg, spec,
                    torch.from_numpy(pos), causal=False,
                    cache={n: v[:, :4] for n, v in xc.items()},
                    kv_source=torch.from_numpy(enc))


# ------------------------------------------------------------ families
def _batch(cfg, b, s, seed, s_enc=11):
    """Numpy inputs of one prompt, as the JAX package's batch_specs lays
    them out: tokens or embeds, encoder frames, M-RoPE positions."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.normal(0, 1, (b, s_enc, cfg.d_model)).astype(
            np.float32)
    if cfg.pos == "mrope":           # temporal, height, width of a 4-wide grid
        i = np.arange(s, dtype=np.int32)
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([i // 8, (i // 4) % 2, i % 4])[:, None], (3, b, s)))
    return out


def _slice(batch, a, z):
    """Tokens a..z of a batch (the encoder's frames whole)."""
    out = {}
    for k, v in batch.items():
        if k == "positions":
            out[k] = v[:, :, a:z]
        elif k in ("tokens", "embeds"):
            out[k] = v[:, a:z]
        else:
            out[k] = v
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_and_logits_match_reference(arch):
    cfg, jcfg, jp, model = _models(arch)
    batch = _batch(cfg, 2, 17, seed=0)
    jh, jaux, _ = JT.forward(jcfg, jp, _jax_batch(batch), mode="train")
    with torch.inference_mode():
        h, aux, cache = model(_torch_batch(batch))
        logits = model.logits_from_hidden(h)
    assert cache is None
    _close(h, jh)
    _close(aux, jaux)
    assert (float(aux) > 0) == (cfg.moe is not None)
    _close(logits, JT.logits_from_hidden(jcfg, jp, jh))


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_decode_and_serve_step_match_reference(arch):
    """Prefill of 16 tokens, then one decode, against the JAX forward in
    the same modes, caches included; then prefill_step + serve_step
    (which takes its position from the cache index) against the argmax of
    JAX's decode logits at that position."""
    cfg, jcfg, jp, model = _models(arch)
    b, s, s_max = 2, 17, 24
    s_enc = 11 if cfg.encoder_layers else None
    batch = _batch(cfg, b, s, seed=1)
    pre, last = _slice(batch, 0, s - 1), _slice(batch, s - 1, s)
    last.pop("enc_embeds", None)
    if cfg.pos != "mrope":
        last["positions"] = np.full((b, 1), s - 1, np.int32)

    jcache = JT.init_cache(jcfg, b, s_max, s_enc)
    jh_pre, _, jcache = JT.forward(jcfg, jp, _jax_batch(pre),
                                   mode="prefill", cache=jcache)
    jh_dec, _, jcache2 = JT.forward(
        jcfg, jp, {**_jax_batch(last), "cache_index": jnp.int32(s - 1)},
        mode="decode", cache=jcache)
    cache = T.init_cache(cfg, b, s_max, "cpu", s_enc=s_enc)
    with torch.inference_mode():
        h_pre, _, cache = model(_torch_batch(pre), mode="prefill",
                                cache=cache)
        h_dec, _, cache = model({**_torch_batch(last), "cache_index": s - 1},
                                mode="decode", cache=cache)
    _close(h_pre, jh_pre)
    _close(h_dec, jh_dec)
    assert set(cache) == set(jcache2)
    for sub, leaves in jcache2.items():
        assert set(cache[sub]) == set(leaves)
        for name, want in leaves.items():
            _close(cache[sub][name], want)

    # the greedy steps, the decode position taken from the cache index
    step = {k: v for k, v in last.items() if k != "positions"}
    pos = np.full((b, 1), s - 1, np.int32)
    if cfg.pos == "mrope":
        pos = np.full((3, b, 1), s - 1, np.int32)
    jh, _, _ = JT.forward(jcfg, jp, {**_jax_batch(step),
                                     "positions": jnp.asarray(pos),
                                     "cache_index": jnp.int32(s - 1)},
                          mode="decode", cache=jcache)
    want = jnp.argmax(JT.logits_from_hidden(jcfg, jp, jh), axis=-1)
    cache = T.init_cache(cfg, b, s_max, "cpu", s_enc=s_enc)
    logits, cache = prefill_step(model, _torch_batch(pre), cache)
    _close(logits, JT.logits_from_hidden(jcfg, jp, jh_pre[:, -1:]))
    nxt, _ = serve_step(model, cache, {**_torch_batch(step),
                                       "cache_index": s - 1})
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (b, 1)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-72b"])
def test_family_prefill_decode_matches_own_forward(arch):
    """Tolerances of tests/test_archs_smoke.py's prefill/decode test, for
    the two families tests/test_torch_lm.py cannot feed tokens alone."""
    cfg, _, _, model = _models(arch)
    b, s = 2, 17
    s_enc = 11 if cfg.encoder_layers else None
    batch = _torch_batch(_batch(cfg, b, s, seed=2))
    with torch.inference_mode():
        h_ref, _, _ = model(batch)
        cache = T.init_cache(cfg, b, s + 3, "cpu", s_enc=s_enc)
        pre = _slice(batch, 0, s - 1)
        h_pre, _, cache = model(pre, mode="prefill", cache=cache)
        last = _slice(batch, s - 1, s)
        last.pop("enc_embeds", None)
        if cfg.pos != "mrope":
            last["positions"] = torch.full((b, 1), s - 1, dtype=torch.int32)
        h_dec, _, _ = model({**last, "cache_index": s - 1}, mode="decode",
                            cache=cache)
    _close(h_pre, h_ref[:, :s - 1], 2e-3)
    _close(h_dec[:, 0], h_ref[:, s - 1], 5e-3)


def test_whisper_decode_needs_the_cross_cache():
    cfg, _, _, model = _models("whisper-small")
    cache = T.init_cache(cfg, 1, 8, "cpu")                # no s_enc
    assert all("xk" not in sub for sub in cache.values())
    with pytest.raises(ValueError, match="s_enc"):
        serve_step(model, cache, {"tokens": torch.zeros((1, 1),
                                                        dtype=torch.int64),
                                  "cache_index": 0})
