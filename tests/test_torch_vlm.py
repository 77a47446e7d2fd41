"""Port vs reference: the VLM family (the VLM branch of
``repro_torch.models.transformer`` vs ``repro.models.transformer``) on the
reduced llama-3.2-vision-90b (4 self layers in 2 sections of a gated cross
layer and 2 self layers, 4 heads over 2 KV heads, 8 image tokens) and a
6-layer variant in 2 sections of 3, the reference's weights loaded through
``params_from_jax`` with every cross gate set to 0.5 (the reference's init
leaves it at 0, which hides the cross layers), f32 caches, the same numpy
inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import TrainState as JTrainState
from repro.optim import make_train_step as jmake_train_step
from repro_torch import lm_train, serve_lm
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamW, TrainState, make_train_step
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.tree import leaves

import torch_lm_cases as C

ARCH = "llama-3.2-vision-90b"
GATE = 0.5
# loss and grads: measured loss gap 4.8e-7 and grads 3.9e-7 apart at most
# (1.0e-6 of the leaf's largest), as tests/test_torch_lm_train.py holds them
GRAD_TOL = dict(rtol=1e-5, atol=2e-6)
# one AdamW step at lr 1e-3: an lm_head element whose grad is -2.1e-8 in the
# reference and -3.2e-8 here (within GRAD_TOL; eps is 1e-8) moves 1.004e-4
# apart in the 6-layer case, where Adam's division amplifies the gap (the
# bound on any element is 2 lr = 2e-3)
STEP_TOL = dict(rtol=0, atol=2e-4)
CROSS_TOL = dict(rtol=0, atol=1e-5)       # attention in f32 (tests/test_kernels.py:124)
B, T = 2, 24


@pytest.fixture(scope="module", params=[{}, {"num_layers": 6, "cross_attn_every": 3}],
                ids=["reduced", "sections_of_3"])
def case(request):
    return C.pair(ARCH, gate=GATE, **request.param)


def _images(case, seed=4):
    return C.inputs(case["cfg"], B, T, seed)


def test_units_put_each_cross_layer_before_its_section(case):
    cfg, model = case["cfg"], case["model"]
    units = TT._units(model)
    kinds = "".join("X" if kind == "cross" else "a" for kind, _ in units)
    every = cfg.cross_attn_every
    assert kinds == ("X" + "a" * every) * (cfg.num_layers // every)
    assert [blk for kind, blk in units if kind == "cross"] == list(model.cross)
    assert [blk for kind, blk in units if kind == "attn"] == list(model.blocks)
    assert TT._remat_span(cfg) == every + 1


def test_params_from_jax_checks_every_leaf(case):
    C.assert_every_leaf_loaded(case)
    cross = case["params"]["cross"]
    assert set(cross) == {"ln", "attn", "gate"}
    assert cross["gate"].shape == (TT.n_cross(case["cfg"]),)
    assert all(float(blk.gate.detach()) == GATE for blk in case["model"].cross)


def test_cross_layers_take_no_bias():
    """``qkv_bias`` gives the self layers biases, never the cross layers
    (``src/repro/models/layers.py:246``), in both packages."""
    case = C.pair(ARCH, gate=GATE, qkv_bias=True)
    assert set(case["params"]["cross"]["attn"]) == {"wq", "wk", "wv", "wo"}
    assert "bq" in case["params"]["blocks"]["attn"]
    C.assert_every_leaf_loaded(case)
    p = TT.init_params(case["cfg"], torch.Generator().manual_seed(5))
    assert set(p["cross"]["attn"]) == {"wq", "wk", "wv", "wo"}


def test_init_params_draw_the_cross_stack():
    cfg = C.configs(ARCH)[1]
    p = TT.init_params(cfg, torch.Generator().manual_seed(5))
    n = cfg.num_layers // cfg.cross_attn_every
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert {k: tuple(v.shape) for k, v in p["cross"]["attn"].items()} == {
        "wq": (n, d, H, hd), "wk": (n, d, K, hd), "wv": (n, d, K, hd), "wo": (n, H, hd, d)}
    assert tuple(p["cross"]["gate"].shape) == (n,) and not p["cross"]["gate"].any()
    assert bool((p["cross"]["ln"] == 1).all())
    model = TT.LM(cfg, device="cpu")
    assert len(model.cross) == n and float(model.cross[0].gate.detach()) == 0.0


def test_prefill_logits_match(case):
    raw = _images(case)
    got = C.port_forward(case, raw)
    assert tuple(got.shape) == (B, T, case["cfg"].vocab_size)
    np.testing.assert_allclose(got.numpy(), C.ref_forward(case, raw), **C.LOGIT_TOL)


def test_emitted_cross_kv_matches(case):
    """``forward(..., return_cache=True)`` emits each section's image keys
    and values as the reference's ``cache["cross_kv"]``, with the same
    logits."""
    raw = _images(case)
    want_logits, jcache = C.ref_forward(case, raw, return_cache=True)
    logits, cross_kv = C.port_forward(case, raw, return_cache=True)
    np.testing.assert_allclose(logits.numpy(), want_logits, **C.LOGIT_TOL)
    cfg = case["cfg"]
    shape = (TT.n_cross(cfg), B, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
    for name in ("k", "v"):
        assert tuple(cross_kv[name].shape) == shape
        np.testing.assert_allclose(cross_kv[name].numpy(), jcache["cross_kv"][name],
                                   **CROSS_TOL)


def test_decode_steps_match(case):
    """24 decode steps against the reference's, each package's cache filled
    with its own emitted image keys and values: logits at every step, every
    self layer's KV cache and the cross K/V at the end."""
    raw = _images(case)
    _, jcache = C.ref_forward(case, raw, return_cache=True)
    _, cross_kv = C.port_forward(case, raw, return_cache=True)
    want, jfinal = C.ref_decode(case, raw["tokens"], max_len=32, cross_kv=jcache["cross_kv"])
    got, cache = C.port_decode(case, raw["tokens"], max_len=32, cross_kv=cross_kv)
    np.testing.assert_allclose(got, want, **C.LOGIT_TOL)
    assert isinstance(cache, TT.VLMCache) and cache.kv.k.shape[0] == case["cfg"].num_layers
    C.assert_kv_matches(cache.kv, jfinal["kv"])
    for name, t in (("k", cache.cross_k), ("v", cache.cross_v)):
        np.testing.assert_allclose(t.numpy(), jfinal["cross_kv"][name], **CROSS_TOL)
    assert cache.length == cache.kv.length == T


def test_decode_matches_prefill(case):
    """``serve_lm.fill_images`` then ``serve_lm.decode`` against the
    prefill on the same tokens and images (tests/test_arch_smoke.py:67-90)."""
    raw = {k: torch.from_numpy(v) for k, v in _images(case).items()}
    model = case["model"]
    cache = TT.init_cache(case["cfg"], B, 32, dtype=torch.float32, device="cpu")
    serve_lm.fill_images(model, cache, raw["tokens"], raw["images"])
    assert cache.length == 0 and bool(cache.cross_k.any())
    ops.reset_launch_counts()
    dec = serve_lm.decode(model, cache, raw["tokens"])
    assert ops.launch_counts()["flash_decode"] == 0            # CPU: plain version
    want = TT.forward(model, raw["tokens"], images=raw["images"])
    np.testing.assert_allclose(dec.numpy(), want.numpy(), **C.LOGIT_TOL)


def test_cached_cross_call_matches_attention_core(case):
    """The decode step's cross call (the ``flash_decode`` route, here its
    plain version) against ``attention_core`` over all image keys, and the
    port's cached cross layer against the reference's."""
    cfg = case["cfg"]
    rng = np.random.default_rng(7)
    H, K, hd, Ti = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_image_tokens
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Ti, K, hd)).astype(np.float32))
            for _ in range(2))
    zeros = torch.zeros((B, 1), dtype=torch.int32)
    want = TL.attention_core(q, k, v, zeros, torch.zeros((B, Ti), dtype=torch.int32),
                             causal=False)
    for use_kernel in (True, False):
        got = TL.cross_attention(q, k, v, decode=True, use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **CROSS_TOL)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), case["params"]["cross"])
    ref = JT._cross_block_cached(jp, jnp.asarray(x), {"k": jnp.asarray(k.numpy()),
                                                      "v": jnp.asarray(v.numpy())}, case["jcfg"])
    got = TT._cross_block_cached(case["model"].cross[1], torch.from_numpy(x),
                                 {"k": k, "v": v}, cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **CROSS_TOL)


def test_loss_grads_and_one_step_match(case):
    ref = C.ref_training(case)
    C.assert_training_matches(case, ref, GRAD_TOL, STEP_TOL)
    cross = ref["grads"]["cross"]          # the gate opens the cross path to the loss
    assert np.abs(cross["gate"]).min() > 0
    assert all(np.abs(cross["attn"][w]).max() > 0 for w in ("wq", "wk", "wv", "wo"))


def test_microbatched_step_matches_reference_and_plain(case):
    """microbatches=2 (the images split on the batch axis with the tokens)
    against the reference's at batch 4 (loss, grad norm, params, moments),
    and its accumulated grads against the plain step's
    (tests/test_arch_smoke.py:94-120)."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    raw = {k: v.numpy() for k, v in lm_train.lm_batch(cfg, 4, 16, 1, "cpu").items()}
    assert raw["images"].shape[0] == 4
    jopt, opt = JAdamW(lr=1e-4), AdamW(lr=1e-4)
    js, jm = jax.jit(jmake_train_step(lambda p, b: JT.loss_fn(p, b, jcfg), jopt,
                                      microbatches=2))(
        JTrainState(jax.tree.map(jnp.asarray, case["params"]), jopt),
        {k: jnp.asarray(v) for k, v in raw.items()})
    loss = lambda p, b: TT.loss_fn(p, b, cfg)   # noqa: E731
    kept = {1: [], 2: []}
    states = {}
    for mb in (1, 2):
        states[mb] = make_train_step(loss, opt, microbatches=mb,
                                     grad_transform=lambda g, mb=mb: kept[mb].append(g) or g)(
            TrainState(C.as_torch(case["params"]), opt), C.batch(raw))
    ts, tm = states[2]
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-6
    assert abs(float(tm["loss"]) - float(states[1][1]["loss"])) < 1e-5
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for part, tol in (("params", C.STEP_PARAM_TOL), ("opt", GRAD_TOL)):
        want, got = jax.tree.leaves(js[part]), leaves(ts[part])
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)
    for a, b in zip(leaves(kept[1][0]), leaves(kept[2][0])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **GRAD_TOL)


def test_remat_gives_the_same_grads(case, monkeypatch):
    """A checkpoint a section (the images one of its inputs) gives the grads
    of no checkpoint at all, bit for bit."""
    raw = {k: v.numpy() for k, v in lm_train.lm_batch(case["cfg"], 2, 16, 0, "cpu").items()}
    loss = lambda p, b: TT.loss_fn(p, b, case["cfg"])   # noqa: E731
    spans = []

    def counting(f, units, *args, **kw):
        spans.append("".join(kind[0] for kind, _ in units))
        return torch.utils.checkpoint.checkpoint(f, units, *args, **kw)
    monkeypatch.setattr(TT, "checkpoint", counting)
    l1, g1 = value_and_grad(loss, C.as_torch(case["params"]), C.batch(raw))
    every = case["cfg"].cross_attn_every
    assert spans == ["c" + "a" * every] * TT.n_cross(case["cfg"])
    monkeypatch.setattr(TT, "checkpoint", lambda f, *a, **k: f(*a))
    l2, g2 = value_and_grad(loss, C.as_torch(case["params"]), C.batch(raw))
    assert torch.equal(l1, l2)
    assert all(torch.equal(x, y) for x, y in zip(leaves(g1), leaves(g2)))


def test_forward_takes_the_family_inputs(case):
    model, cfg = case["model"], case["cfg"]
    raw = {k: torch.from_numpy(v) for k, v in _images(case).items()}
    with pytest.raises(ValueError, match="images"):
        TT.forward(model, raw["tokens"])
    with pytest.raises(ValueError, match="frames"):
        TT.forward(model, raw["tokens"], images=raw["images"], frames=raw["images"])
    with pytest.raises(ValueError, match="return_cache"):
        TT.forward(model, raw["tokens"], images=raw["images"], mode="train",
                   return_cache=True)
    dense = TT.LM(C.configs("smollm-135m")[1], device="cpu")
    with pytest.raises(ValueError, match="VLM alone"):
        TT.forward(dense, raw["tokens"], images=raw["images"])
    with pytest.raises(ValueError, match="return_cache"):
        TT.forward(dense, raw["tokens"], return_cache=True)
    cache = TT.init_cache(cfg, B, 8, device="cpu")
    with pytest.raises(ValueError, match="cross k"):
        cache.load_cross({"k": torch.zeros(1), "v": torch.zeros(1)})


def test_entry_points_on_cpu(capsys):
    serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "3",
                   "--tokens", "20", "--max-len", "24"])
    lm_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "2",
                   "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert "(vlm)" in out[0] and "finite: True" in out[1]
    assert "; cross K/V fill " in out[2]
    assert out[3] == "  flash_decode launches: 0"
    assert out[4].startswith("llama-3.2-vision-90b-reduced: 4L d=64")
    assert [ln.split(" loss ")[0] for ln in out[5:]] == ["  step    0", "  step    2"]
    assert all(np.isfinite(float(ln.split(" loss ")[1])) for ln in out[5:])
