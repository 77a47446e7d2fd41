"""Port vs reference: the SSM family (``repro_torch.models.ssd`` and the SSM
branch of ``repro_torch.models.transformer`` vs ``repro.models.ssd`` and
``repro.models.transformer``) on the reduced mamba2-1.3b (2 layers, d 64,
state 16, 8 heads of 16, chunk 16), the reference's weights loaded through
``params_from_jax``, f32 caches, the same numpy inputs; and the one
departure, the intra-chunk decay masked before its ``exp``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as jssd
from repro.models import transformer as JT
from repro_torch import lm_train, serve_lm
from repro_torch.data import make_lm_batch
from repro_torch.models import ssd as tssd
from repro_torch.models import transformer as TT
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.tree import leaves

import torch_lm_cases as C

ARCH = "mamba2-1.3b"
# ssd_forward and its decode step alone, f32, outputs up to about 12:
# measured 5.7e-6 at most (forward), 1.9e-6 (final state), 1.2e-6 (decode
# outputs), 3.8e-6 (decode caches)
SSD_TOL = dict(rtol=1e-5, atol=5e-6)
# a bf16 cache: one bf16 step (measured 1.7e-6 outputs, 3.1e-5 caches)
BF16_TOL = dict(rtol=1e-2, atol=1e-4)
# loss and grads: measured loss gap 0 and grads 1.3e-6 apart at most
# (3.4e-6 of the leaf's largest)
GRAD_TOL = dict(rtol=1e-5, atol=4e-6)
B, T = 2, 24


@pytest.fixture(scope="module")
def case():
    return C.pair(ARCH)


def _layer0(case):
    p = jax.tree.map(lambda a: a[0], case["params"]["blocks"]["ssd"])
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _u(case, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, case["cfg"].d_model)).astype(np.float32)


@pytest.mark.parametrize("S,with_state", [(32, False), (21, False), (48, True)])
def test_ssd_forward_matches_reference(case, S, with_state):
    """S a multiple of the chunk of 16, S padded to one, and a carried-in
    state: the outputs and the final state."""
    p, tp = _layer0(case)
    cfg = case["cfg"]
    u = _u(case, 2, S, seed=S)
    h0 = (np.random.default_rng(1).standard_normal(
        (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
        if with_state else None)
    want, want_state = jssd.ssd_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(u),
                                        case["jcfg"], None if h0 is None else jnp.asarray(h0))
    got, state = tssd.ssd_forward(tp, torch.from_numpy(u), cfg,
                                  None if h0 is None else torch.from_numpy(h0))
    assert tuple(got.shape) == (2, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_steps_and_cache_match(case, dtype):
    """12 recurrent steps of one layer from a zero cache: the outputs and
    every cache leaf after each step, the state kept in the cache's dtype
    between steps as the reference keeps it (bf16: within one bf16 step)."""
    p, tp = _layer0(case)
    jcache = jssd.init_ssd_cache(case["jcfg"], 2, getattr(jnp, dtype))
    cache = {k: v[0] for k, v in tssd.init_ssd_cache(case["cfg"], 2,
                                                     dtype=getattr(torch, dtype)).items()}
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    tol = SSD_TOL if dtype == "float32" else BF16_TOL
    u = _u(case, 2, 12, seed=5)
    jstep = jax.jit(jssd.ssd_decode_step, static_argnums=3)
    for t in range(12):
        want, jcache = jstep(jax.tree.map(jnp.asarray, p), jnp.asarray(u[:, t:t + 1]),
                             jcache, case["jcfg"])
        got = tssd.ssd_decode_step(tp, torch.from_numpy(u[:, t:t + 1]), cache, case["cfg"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol, err_msg=f"step {t}")
        for k, v in cache.items():
            assert v.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(v.float().numpy(), np.asarray(jcache[k], np.float32),
                                       **tol, err_msg=f"step {t} {k}")


def test_params_from_jax_checks_every_leaf(case):
    C.assert_every_leaf_loaded(case)


def test_init_params_draws_the_reference_distributions():
    cfg = dataclasses.replace(C.configs(ARCH)[1], d_model=256)
    p = TT.init_params(cfg, torch.Generator().manual_seed(5))["blocks"]["ssd"]
    d, di, W = cfg.d_model, cfg.d_inner, cfg.ssm_conv
    for name, fan_in in (("z_proj", d), ("x_proj", d), ("dt_proj", d), ("out_proj", di),
                         ("conv_x", W)):
        assert abs(float(p[name].std()) * fan_in ** 0.5 - 1) < 0.05, name
    for name in tssd.ZERO_INIT:
        assert not p[name].any(), name
    assert bool((p["D"] == 1).all())


def test_prefill_logits_match(case):
    toks = C.tokens(case["cfg"], B, T)
    got = TT.forward(case["model"], torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), C.ref_prefill(case, toks), **C.LOGIT_TOL)


def test_decode_steps_match(case):
    """24 decode steps against the reference's: logits at every step, and
    every layer's SSD cache at the end."""
    toks = C.tokens(case["cfg"], B, T)
    want, jcache = C.ref_decode(case, toks, max_len=32)
    got, cache = C.port_decode(case, toks, max_len=32)
    np.testing.assert_allclose(got, want, **C.LOGIT_TOL)
    C.assert_ssd_matches(cache, jcache["ssd"])
    assert cache.length == T


def test_decode_matches_prefill(case):
    toks = torch.from_numpy(C.tokens(case["cfg"], B, T))
    cache = TT.init_cache(case["cfg"], B, 32, dtype=torch.float32, device="cpu")
    dec = serve_lm.decode(case["model"], cache, toks)
    np.testing.assert_allclose(dec.numpy(), TT.forward(case["model"], toks).numpy(),
                               **C.LOGIT_TOL)


def test_loss_grads_and_one_step_match(case):
    C.assert_training_matches(case, C.ref_training(case), GRAD_TOL)


def test_masked_exp_departure_gives_finite_grads():
    """At the configs' chunk of 256 and S 512 the reference's
    ``where(tri, exp(seg), 0)`` overflows above the diagonal: its grads are
    not all finite. The port masks before the exp: the same loss (within
    1e-5; measured 9.5e-7), every grad finite."""
    jcfg, cfg = C.configs(ARCH, ssm_chunk=256)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    raw = make_lm_batch(cfg.vocab_size, 2, 512, seed=0, step=0)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, jcfg)))(
        params, {k: jnp.asarray(v) for k, v in raw.items()})
    assert np.isfinite(float(loss))
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(grads))
    tloss, tgrads = value_and_grad(lambda p, b: TT.loss_fn(p, b, cfg),
                                   C.as_torch(jax.tree.map(np.asarray, params)), C.batch(raw))
    assert abs(float(tloss) - float(loss)) < 1e-5
    assert all(bool(torch.isfinite(g).all()) for g in leaves(tgrads))


def test_entry_points_on_cpu(capsys):
    serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "3",
                   "--tokens", "20", "--max-len", "24"])
    lm_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "2",
                   "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert "(ssm)" in out[0] and "finite: True" in out[1]
    assert out[3] == "  flash_decode launches: 0"
    assert [ln.split(" loss ")[0] for ln in out[5:]] == ["  step    0", "  step    2"]
    assert all(np.isfinite(float(ln.split(" loss ")[1])) for ln in out[5:])


def test_float64_copy_is_a_yardstick(case):
    """A float64 copy of the model (``.double()``) runs every step of the
    SSM path in float64 (``rms_norm`` and the SSD casts follow the input
    dtype): its decode equals its prefill to float64 rounding, and the f32
    model's decode and prefill each lie within f32 rounding of it."""
    toks = torch.from_numpy(C.tokens(case["cfg"], B, T))
    f64 = TT.LM(case["cfg"], device="cpu", params=TT.tree_of(case["model"])).double()
    dec64 = serve_lm.decode(f64, TT.init_cache(case["cfg"], B, T, torch.float64, "cpu"), toks)
    pre64 = TT.forward(f64, toks)
    assert dec64.dtype == pre64.dtype == torch.float64
    assert float((dec64 - pre64).abs().max()) < 1e-12
    dec32 = serve_lm.decode(case["model"], TT.init_cache(case["cfg"], B, T, torch.float32,
                                                         "cpu"), toks)
    for got in (dec32, TT.forward(case["model"], toks)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.double().numpy(), dec64.numpy(), **C.LOGIT_TOL)
