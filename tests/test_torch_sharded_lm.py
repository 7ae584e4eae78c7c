"""The port's sharded LM serving (``Transformer(cfg, mesh=)``,
``init_cache(..., mesh=)``, ``prefill_step``/``serve_step`` on a mesh)
against the JAX package's mesh-free forward and the unsharded port, on
the CPU over gloo.

Worlds of 2 and 4 ranks run as spawned processes
(``tests/_torch_lm_worker.py``) on meshes (1, 2), (2, 1), (2, 2), (1, 4)
and (pod, data, model) = (2, 2, 1), where the batch splits over pod x
data but the cache's batch over data alone.  Each serves the smoke widths
of Jamba with its experts (one full period: attention, Mamba, dense and
MoE sub-layers), granite-moe, rwkv6, whisper-small (encoder and cross
cache) and qwen2-vl (embeds, M-RoPE), with the JAX package's weights
carried by ``params_from_reference(..., mesh=)``:

* the last prefill logits within 1e-4 (f32) of the JAX mesh-free forward
  (``T.forward(..., mode="prefill", cache=...)`` and
  ``logits_from_hidden``);
* 8 greedy tokens equal to the unsharded port's, on every rank;
* ``unshard_tree`` of the cache within 1e-4 of the unsharded port's;
* bytes handed to the collectives on every mesh of more than one rank.

The cache sizes vary by mesh, so the attention cache is split by
sequence ((1, 2), (1, 4)), by kv heads ((2, 2)) or whole ((2, 2, 1)).
Every world has a timeout: a hang fails the test.
"""

import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_worker as W  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, init_world  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

FAMILIES = ["jamba-1.5-large-398b", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "whisper-small", "qwen2-vl-72b"]
# granite-moe routing the whole batch as one group (the capacity counts
# every rank's rows): a rank whose rows are a block of the batch gathers
# them all before routing
UNGROUPED = "granite-moe-1b-a400m+ungrouped"
# mesh -> (global batch, cache positions)
MESHES = {(1, 2): (2, 32), (2, 1): (2, 32), (2, 2): (2, 31), (1, 4): (2, 32),
          (2, 2, 1): (4, 30)}
S, S_ENC, N_DEC = 8, 6, 8
TOL = 1e-4
WORLD_TIMEOUT_S = 300
TESTS = str(Path(__file__).resolve().parent)


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


def _cfgs(name: str):
    arch, _, variant = name.partition("+")
    over = {"moe_grouped_dispatch": False} if variant == "ungrouped" else {}
    return (get_smoke_config(arch).scaled(**over),
            jget_smoke(arch).scaled(**over))


def _case(arch: str, b: int, s_max: int) -> dict:
    """A smoke config with the JAX package's weights, a seeded prompt
    (tokens or embeddings, encoder frames, M-RoPE positions) and the
    decode feeds."""
    cfg, jcfg = _cfgs(arch)
    params = jax.tree.map(np.asarray, JT.init_params(jcfg, 0))
    rng = np.random.default_rng(7)
    batch = {}
    if cfg.input_mode == "embeds":
        batch["embeds"] = rng.normal(0, 1, (b, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, S)).astype(np.int64)
    s_enc = S_ENC if cfg.encoder_layers else None
    if s_enc:
        batch["enc_embeds"] = rng.normal(0, 1, (b, s_enc, cfg.d_model)
                                         ).astype(np.float32)
    if cfg.pos == "mrope":
        i = np.arange(S, dtype=np.int32)
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([i // 4, (i // 2) % 2, i % 2])[:, None], (3, b, S)))
    feeds = [None] * N_DEC
    if cfg.input_mode == "embeds":
        feeds = list(rng.normal(0, 1, (N_DEC, b, 1, cfg.d_model)).astype(
            np.float32))
    # then 3 tokens at once into the cache (a continued prefill: on a
    # sequence-split cache, every block's partial attention merged)
    ext = (rng.integers(0, cfg.vocab, (b, 3)).astype(np.int64)
           if cfg.input_mode == "tokens" else None)
    return {"arch": arch, "cfg": cfg, "jcfg": jcfg, "params": params,
            "batch": batch, "feeds": feeds, "b": b, "s": S, "s_max": s_max,
            "s_enc": s_enc, "extend": ext}


def _jax_last_logits(c: dict) -> np.ndarray:
    jcfg = c["jcfg"]
    jp = jax.tree.map(jnp.asarray, c["params"])
    batch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    cache = JT.init_cache(jcfg, c["b"], c["s_max"], c["s_enc"])
    hidden, _, _ = JT.forward(jcfg, jp, batch, mode="prefill", cache=cache)
    return np.asarray(JT.logits_from_hidden(jcfg, jp, hidden[:, -1:]))


def _unsharded(c: dict) -> dict:
    cfg = c["cfg"]
    model = T.params_from_reference(cfg, c["params"], device="cpu")
    cache = T.init_cache(cfg, c["b"], c["s_max"], "cpu", s_enc=c["s_enc"])
    last, toks = W.greedy(model, cache, W._as_torch(c["batch"]), c["s"],
                          [None if e is None else torch.from_numpy(e)
                           for e in c["feeds"]])
    ext = None
    if c["extend"] is not None:
        ext = W.extend(model, cache, torch.from_numpy(c["extend"]),
                       c["s"] + len(c["feeds"])).numpy()
    return {"last": last.numpy(), "tokens": toks.numpy(),
            "cache": W._np_tree(cache), "extend": ext}


_WORLDS: dict = {}


def _world(shape):
    """The world of ``shape`` (run once), with each family's references."""
    if shape not in _WORLDS:
        b, s_max = MESHES[shape]
        cases = [_case(a, b, s_max) for a in FAMILIES + [UNGROUPED]]
        outs = _run("_torch_lm_worker:serve", int(np.prod(shape)),
                    (shape, [{k: v for k, v in c.items() if k != "jcfg"}
                             for c in cases]))
        refs = {c["arch"]: {**_unsharded(c), "jax": _jax_last_logits(c),
                            "params": sum(x.size for x in jax.tree.leaves(
                                c["params"]))}
                for c in cases}
        _WORLDS[shape] = (outs, refs)
    return _WORLDS[shape]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", FAMILIES + [UNGROUPED])
@pytest.mark.parametrize("shape", list(MESHES),
                         ids=["x".join(map(str, s)) for s in MESHES])
def test_sharded_serving_matches_jax_and_the_unsharded_port(shape, arch):
    outs, refs = _world(shape)
    ref = refs[arch]
    assert [o["rank"] for o in outs] == list(range(len(outs)))
    for o in outs:
        got = o[arch]
        _close(got["last"], ref["jax"])
        _close(got["last"], ref["last"])
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        if ref["extend"] is not None and got["extend"] is not None:
            _close(got["extend"], ref["extend"])
        assert got["cache"].keys() == ref["cache"].keys()
        for sub, leaves in ref["cache"].items():
            assert got["cache"][sub].keys() == leaves.keys()
            for name, want in leaves.items():
                _close(got["cache"][sub][name], want)
        assert got["sent"] > 0
        # each rank holds less than the whole model
        assert got["held"] < ref["params"]


def test_vocab_argmax_breaks_ties_at_the_lowest_global_id():
    outs = _run("_torch_lm_worker:tie_break", 2)
    full = torch.tensor(W.TIE_LOGITS)
    want = {str(dt): torch.argmax(full.to(dt), dim=-1).tolist()
            for dt in (torch.float32, torch.bfloat16)}
    assert want[str(torch.float32)] == want[str(torch.bfloat16)] == [
        2, 5, 7, 1]
    assert outs == [want, want]


@pytest.mark.parametrize("over", [{}, {"vocab": 253,
                                       "vocab_pad_multiple": 3}],
                         ids=["vocab_split", "vocab_replicated"])
def test_serving_logits_on_a_mesh_equal_the_unsharded_port(over):
    """On a (1, 2) mesh: the prefill logits, the greedy tokens and each
    ``decode_logits`` step's logits equal the same seeded model's served
    unsharded, and each step's argmax is the served token.  A padded
    vocabulary of 256 splits over the model axis; one of 255 does not, so
    ``lm_head`` stays whole on each rank and the logits are 255 wide (not
    gathered twice over)."""
    cfg = get_smoke_config("qwen2-7b").scaled(**over)
    v = cfg.padded_vocab
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, S))
    outs = _run("_torch_lm_worker:vocab_mesh", 2,
                ("qwen2-7b", over, prompt, 4))
    model = T.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    cache = T.init_cache(cfg, 2, S + 4, "cpu")
    batch = {"tokens": torch.from_numpy(prompt)}
    last, toks = W.greedy(model, cache, batch, S, [None] * 4)
    steps = W.logit_steps(model, cache, batch, S, toks[:, :-1])
    for o in outs:
        assert o["lm_head"] == (cfg.d_model, v // 2 if v % 2 == 0 else v)
        assert o["last"].shape == (2, 1, v)
        _close(o["last"], last.numpy())
        np.testing.assert_array_equal(o["tokens"], toks.numpy())
        assert len(o["steps"]) == 4
        for i, (got, want) in enumerate(zip(o["steps"], steps)):
            assert got.shape == (2, 1, v)
            _close(got, want.numpy())
            np.testing.assert_array_equal(got[:, 0].argmax(-1),
                                          o["tokens"][:, i + 1])


@pytest.fixture
def unit_mesh():
    """A (1, 1) mesh over a gloo world of one rank, in this process."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as d:
        init_world("gloo", init_method=f"file://{d}/rendezvous", rank=0,
                   world_size=1)
        try:
            yield Mesh((1, 1), device="cpu")
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", FAMILIES)
def test_unit_mesh_serves_bit_for_bit_as_unsharded(unit_mesh, arch):
    """On one rank the sharded code is the identity: the same logits,
    tokens and cache to the bit, and no collective or layout bytes."""
    c = _case(arch, 2, 32)
    ref = _unsharded(c)
    model = T.params_from_reference(c["cfg"], c["params"], mesh=unit_mesh)
    cache = T.init_cache(c["cfg"], 2, 32, s_enc=c["s_enc"], mesh=unit_mesh)
    last, toks = W.greedy(model, cache, W._as_torch(c["batch"]), c["s"],
                          [None if e is None else torch.from_numpy(e)
                           for e in c["feeds"]])
    np.testing.assert_array_equal(last.numpy(), ref["last"])
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"])
    if c["extend"] is not None:
        ext = W.extend(model, cache, torch.from_numpy(c["extend"]),
                       c["s"] + len(c["feeds"]))
        np.testing.assert_array_equal(ext.numpy(), ref["extend"])
    got = W._np_tree(T.unshard_tree(cache, cache.specs, unit_mesh))
    for sub, leaves in ref["cache"].items():
        for name, want in leaves.items():
            np.testing.assert_array_equal(got[sub][name], want)
    assert sum(unit_mesh.sent_bytes.values()) == 0
    assert unit_mesh.layout_bytes == 0


def test_seeded_sharded_model_holds_the_blocks_of_the_unsharded_draw(
        unit_mesh):
    """A seeded model on a mesh draws each leaf whole, in order, from the
    same generator: its blocks are ``shard_tree`` of the unsharded draw
    (here on the unit mesh, and the (2, 2) blocks of rank 3 computed from
    the same draw)."""
    cfg = get_smoke_config("jamba-1.5-large-398b")
    full = T.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    model = T.Transformer(cfg, generator=torch.Generator().manual_seed(4),
                          mesh=unit_mesh)
    flat = T._map2(lambda a, b: torch.equal(a, b), model.params.tree(),
                   full)
    assert all(jax.tree.leaves(flat))
    stub = type("Stub", (), {"axis_names": ("data", "model"),
                             "shape": (2, 2)})()
    specs = T.param_pspecs(cfg, stub)
    blocks = T.shard_tree(full, specs, stub, rank=3)
    tok = blocks["embed"]["tok"]
    assert tuple(tok.shape) == (cfg.padded_vocab // 2, cfg.d_model // 2)
    assert torch.equal(tok, full["embed"]["tok"][cfg.padded_vocab // 2:,
                                                 cfg.d_model // 2:])


def test_a_sharded_model_refuses_training_and_a_plain_cache(unit_mesh):
    """A sharded model refuses a cache that is not ``init_cache(...,
    mesh=)``'s.  It trains: on the unit mesh ``loss_fn`` and every
    gradient equal the unsharded model's bit for bit (the differentiable
    collectives are the identity on one rank), with no collective bytes."""
    cfg = get_smoke_config("qwen2-7b")
    model = T.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                          mesh=unit_mesh)
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="mesh="):
        model({"tokens": tokens}, mode="prefill",
              cache=T.init_cache(cfg, 2, 8, "cpu"))
    plain = T.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    batch = {"tokens": torch.arange(8).reshape(2, 4),
             "labels": torch.arange(1, 9).reshape(2, 4)}
    grads = []
    for m in (model, plain):
        m.requires_grad_(True)
        loss, _ = T.loss_fn(m, batch)
        loss.backward()
        grads.append((loss, [p.grad for p in m.parameters()]))
    (lm, gm), (lp, gp) = grads
    assert torch.equal(lm, lp) and len(gm) == len(gp)
    assert all(torch.equal(a, b) for a, b in zip(gm, gp))
    assert sum(unit_mesh.sent_bytes.values()) == 0


def test_serve_lm_example_on_two_ranks_equals_the_unsharded_port():
    """``examples/serve_lm.py`` (what ``torchrun`` starts on each card) on a
    world of two CPU ranks: every rank gets the greedy tokens of the same
    seeded model served unsharded."""
    argv = ["--device", "cpu", "--smoke", "--steps", "4"]
    outs = _run("repro_torch.examples.serve_lm:main", 2, (argv,))
    cfg = get_smoke_config("jamba-1.5-large-398b")
    model = T.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    cache = T.init_cache(cfg, 2, 64, "cpu")
    _, toks = W.greedy(model, cache, {"tokens": torch.from_numpy(prompt)},
                       16, [None] * 4)
    for o in outs:
        assert o["mesh"] == (1, 2) and o["held"] < cfg.param_count()
        assert o["tokens"] == toks.tolist()
        assert sum(o["sent_bytes"].values()) > 0 and o["layout_bytes"] > 0
