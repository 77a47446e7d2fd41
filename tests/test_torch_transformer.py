"""Port vs reference: the dense-family LM (``repro_torch.models.transformer``
vs ``repro.models.transformer``) and the LM serving slice
(``repro_torch.serve_lm``) on the reduced configs of smollm-135m (GQA),
qwen1.5-0.5b (QKV bias) and granite-34b (MQA, GELU), with the reference's
weights loaded through ``params_from_jax`` and an f32 cache, as
``tests/test_arch_smoke.py`` decodes; and the config copies of every arch
with a decode step. The MoE, SSM, hybrid, VLM and encoder families have
their own files (``test_torch_moe.py``, ``test_torch_ssd.py``,
``test_torch_hybrid.py``, ``test_torch_vlm.py``, ``test_torch_encoder.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch import serve_lm
from repro_torch.configs import DECODE_ARCHS, SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT

ARCHS = ["smollm-135m", "qwen1.5-0.5b", "granite-34b"]
LOGIT_TOL = dict(rtol=0, atol=5e-5)           # tests/test_arch_smoke.py:90
KV_TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 24


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, reference params as numpy, the port's model loaded
    from them, seeded tokens [B, T])."""
    arch = request.param
    jcfg = jget_config(arch).reduced()
    params = jax.tree_util.tree_map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    model = TT.params_from_jax(TT.LM(get_config(arch).reduced(), device="cpu"), params)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    return jcfg, params, model, tokens


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_config_copy_agrees(arch):
    for t, j in ((get_config(arch), jget_config(arch)),
                 (get_config(arch).reduced(), jget_config(arch).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert (t.attn_free, t.subquadratic, t.skipped("long_500k")) == \
            (j.attn_free, j.subquadratic, j.skipped("long_500k"))
    assert {n: dataclasses.asdict(s) for n, s in SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in JSHAPES.items()}


def test_params_from_jax_checks_every_leaf(pair):
    jcfg, params, model, _ = pair
    L = jcfg.num_layers
    for i, blk in enumerate(model.blocks):
        np.testing.assert_array_equal(blk.attn["wq"].detach().numpy(),
                                      params["blocks"]["attn"]["wq"][i])
        np.testing.assert_array_equal(blk.mlp["w2"].detach().numpy(),
                                      params["blocks"]["mlp"]["w2"][i])
    np.testing.assert_array_equal(model.embed.detach().numpy(), params["embed"])
    n_leaves = len(jax.tree_util.tree_leaves(params))
    n_top = len(params) - 1                    # embed, final_norm, lm_head
    assert sum(1 for _ in model.parameters()) == (n_leaves - n_top) * L + n_top
    cfg = model.cfg
    fresh = TT.LM(cfg, device="cpu")
    bad_wo = jax.tree_util.tree_map(lambda a: a, params)
    bad_wo["blocks"]["attn"]["wo"] = params["blocks"]["attn"]["wo"].transpose(0, 3, 1, 2)
    with pytest.raises(ValueError, match="wo"):
        TT.params_from_jax(fresh, bad_wo)
    short = jax.tree_util.tree_map(lambda a: a, params)
    short["blocks"]["ln1"] = params["blocks"]["ln1"][:-1]
    with pytest.raises(ValueError, match="ln1"):
        TT.params_from_jax(fresh, short)
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["blocks"]["mlp"]["w1"]
    with pytest.raises(ValueError, match="mlp"):
        TT.params_from_jax(fresh, missing)


def test_prefill_logits_match(pair):
    jcfg, params, model, tokens = pair
    want, _, _ = JT.forward(jax.tree_util.tree_map(jnp.asarray, params),
                            {"tokens": jnp.asarray(tokens)}, jcfg, mode="prefill")
    got = TT.forward(model, torch.from_numpy(tokens))
    assert tuple(got.shape) == (B, T, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_decode_steps_match(pair):
    """24 decode steps against the reference's decode_step: logits, cache
    positions and valid flags, cached keys and values."""
    jcfg, params, model, tokens = pair
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstep = jax.jit(JT.decode_step, static_argnums=3)
    jcache = JT.init_cache(jcfg, B, max_len=32, dtype=jnp.float32)
    cache = TT.init_cache(model.cfg, B, 32, dtype=torch.float32, device="cpu")
    for t in range(T):
        want, jcache = jstep(jparams, jcache, {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                                               "pos": jnp.array(t, jnp.int32)}, jcfg)
        got, cache = TT.decode_step(model, cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL,
                                   err_msg=f"step {t}")
    assert cache.length == T
    kv = jcache["kv"]
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(kv["pos"]))
    np.testing.assert_array_equal(cache.valid.numpy(), np.asarray(kv["valid"]))
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(kv["k"]), **KV_TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(kv["v"]), **KV_TOL)


def test_decode_matches_prefill(pair):
    _, _, model, tokens = pair
    tt = torch.from_numpy(tokens)
    cache = TT.init_cache(model.cfg, B, 32, dtype=torch.float32, device="cpu")
    ops.reset_launch_counts()
    dec = serve_lm.decode(model, cache, tt)
    assert ops.launch_counts()["flash_decode"] == 0            # CPU: plain version
    np.testing.assert_allclose(dec.numpy(), TT.forward(model, tt).numpy(), **LOGIT_TOL)


def test_init_params_draws_the_reference_distributions():
    cfg = dataclasses.replace(get_config("granite-34b").reduced(), d_model=256,
                              d_ff=512, tie_embeddings=False, qkv_bias=True)
    p = TT.init_params(cfg, torch.Generator().manual_seed(5))
    q = TT.init_params(cfg, torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(p),
                                                  jax.tree_util.tree_leaves(q)))
    H, hd, d, f = cfg.num_heads, cfg.head_dim, cfg.d_model, cfg.d_ff
    std = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5, "wo": (H * hd) ** -0.5}
    for name, s in std.items():
        assert abs(float(p["blocks"]["attn"][name].std()) / s - 1) < 0.05, name
    assert abs(float(p["blocks"]["mlp"]["w1"].std()) * d ** 0.5 - 1) < 0.05
    assert abs(float(p["blocks"]["mlp"]["w2"].std()) * f ** 0.5 - 1) < 0.05
    for name in ("embed", "lm_head"):
        assert abs(float(p[name].std()) / 0.02 - 1) < 0.05
    assert not p["blocks"]["attn"]["bq"].any()
    assert bool((p["blocks"]["ln1"] == 1).all() and (p["final_norm"] == 1).all())


def test_same_seed_same_model():
    cfg = get_config("smollm-135m").reduced()
    a = serve_lm.build(cfg, seed=4, torch_device="cpu")
    b = serve_lm.build(cfg, seed=4, torch_device=torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_serve_lm_entry_point_on_cpu(capsys):
    serve_lm.main(["--device", "cpu", "--reduced", "--batch", "3", "--tokens", "5",
                   "--max-len", "8"])
    out = capsys.readouterr().out
    assert "decoded 5 positions x 3 sequences" in out and "finite: True" in out


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main(["--reduced", "--tokens", "1"])


def test_out_of_order_position_raises():
    cfg = get_config("smollm-135m").reduced()
    model = TT.LM(cfg, device="cpu")
    cache = TT.init_cache(cfg, 2, 8, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="in order"):
        TT.decode_step(model, cache, tok, 1)                # nothing written yet
    TT.decode_step(model, cache, tok, 0)
    with pytest.raises(ValueError, match="in order"):
        TT.decode_step(model, cache, tok, 0)                # position 0 again
    with pytest.raises(ValueError, match=r"\[B, 1\]"):
        TT.decode_step(model, cache, torch.zeros((2, 2), dtype=torch.int32), 1)
    assert cache.length == 1


def test_forward_rejects_an_unknown_mode():
    model = TT.LM(get_config("smollm-135m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        TT.forward(model, torch.zeros((1, 2), dtype=torch.int32), mode="decode")
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), family="retnet")
    with pytest.raises(ValueError, match="unknown family"):
        TT.LM(cfg, device="cpu")
