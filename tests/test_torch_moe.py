"""Port vs reference: the MoE family (``repro_torch.models.moe`` and the MoE
branches of ``repro_torch.models.transformer`` vs ``repro.models.moe`` and
``repro.models.transformer``) on the reduced deepseek-moe-16b (4 experts
top-2 plus a shared expert) and mixtral-8x22b (4 experts top-2, a 16-slot
sliding window), the reference's weights loaded through ``params_from_jax``,
f32 caches, the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch import lm_train, serve_lm
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT

import torch_lm_cases as C

ARCHS = ["deepseek-moe-16b", "mixtral-8x22b"]
# moe_ffn alone, f32, outputs up to about 12: measured 4.3e-6 at most (the
# sums over experts and the GEMMs' blocking in another order); aux 1.2e-7
FFN_TOL = dict(rtol=1e-5, atol=5e-6)
# loss and grads: measured loss gaps of 0 and grads 1.9e-6 apart at most
# (9.4e-7 of the leaf's largest)
GRAD_TOL = dict(rtol=1e-5, atol=4e-6)
B, T = 2, 24


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return C.pair(request.param)


def _moe_inputs(case, B, S, seed):
    """Layer 0's MoE weights (numpy and torch) and an input x [B, S, d]."""
    p = jax.tree.map(lambda a: a[0], case["params"]["blocks"]["moe"])
    x = np.random.default_rng(seed).standard_normal((B, S, case["cfg"].d_model)).astype(np.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}, x


def _ffn_both(case, B, S, seed, **replace):
    jcfg, cfg = (dataclasses.replace(c, **replace) for c in (case["jcfg"], case["cfg"]))
    p, tp, x = _moe_inputs(case, B, S, seed)
    want, want_aux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    return np.asarray(want), float(want_aux), got.numpy(), float(aux)


def test_moe_ffn_matches_reference(case):
    want, want_aux, got, aux = _ffn_both(case, 3, 24, seed=1)
    np.testing.assert_allclose(got, want, **FFN_TOL)
    assert abs(aux - want_aux) < 1e-6
    if case["cfg"].num_shared_experts:          # deepseek: the shared expert is on
        p = case["params"]["blocks"]["moe"]
        np.testing.assert_array_equal(p["shared_w3"], p["shared_w1"])


def test_moe_ffn_two_groups(case):
    """S 512 > GROUP_TOKENS and a multiple of it: two routing groups a row,
    capacity per group."""
    want, want_aux, got, aux = _ffn_both(case, 2, 512, seed=2)
    np.testing.assert_allclose(got, want, **FFN_TOL)
    assert abs(aux - want_aux) < 1e-6


@pytest.mark.parametrize("S", [24, 512])
def test_forced_drops_keep_the_reference_assignment(case, S):
    """moe_capacity_factor 0.25 drops tokens: the kept (token, expert)
    assignments equal the non-zeros of the reference's dispatch, their
    combine weights its combine's, bit for bit, on the same gates; the layer's
    output and aux loss follow."""
    cf = 0.25
    k, E = case["cfg"].top_k, case["cfg"].num_experts
    G = 4
    gates = jax.nn.softmax(jnp.asarray(
        np.random.default_rng(S).standard_normal((G, min(S, 256), E)).astype(np.float32)), -1)
    capacity = max(k, int(cf * gates.shape[1] * k / E))
    dispatch, combine = jmoe._topk_dispatch(gates, k, capacity)
    dispatch, combine = np.asarray(dispatch), np.asarray(combine)
    g, s, e, _ = np.nonzero(dispatch)
    want = sorted(zip((g * gates.shape[1] + s).tolist(), e.tolist()))
    assert len(want) < G * gates.shape[1] * k                 # something was dropped
    tok, exp, rnd, kept = tmoe.topk_assign(torch.from_numpy(np.array(gates)), k, capacity)
    assert sorted(zip(tok.tolist(), exp.tolist())) == want
    np.testing.assert_array_equal(kept.numpy(), dispatch.sum(axis=(1, 3)).astype(np.int64))
    flat = np.asarray(gates).reshape(-1, E)
    weights = combine.sum(axis=3).reshape(-1, E)
    np.testing.assert_array_equal(flat[tok.numpy(), exp.numpy()],
                                  weights[tok.numpy(), exp.numpy()])
    assert len(set(zip(tok.tolist(), rnd.tolist()))) == len(tok)   # one slot a round
    want_y, want_aux, got_y, aux = _ffn_both(case, 2, S, seed=3, moe_capacity_factor=cf)
    np.testing.assert_allclose(got_y, want_y, **FFN_TOL)
    assert abs(aux - want_aux) < 1e-6


def test_params_from_jax_checks_every_leaf(case):
    C.assert_every_leaf_loaded(case)


def test_init_params_draws_the_reference_distributions():
    cfg = dataclasses.replace(C.configs("deepseek-moe-16b")[1], d_model=256, moe_d_ff=512)
    p = TT.init_params(cfg, torch.Generator().manual_seed(5))["blocks"]["moe"]
    d, f = cfg.d_model, cfg.moe_d_ff
    for name, fan_in in (("router", d), ("w1", d), ("w3", d), ("w2", f),
                         ("shared_w1", d), ("shared_w2", f)):
        assert abs(float(p[name].std()) * fan_in ** 0.5 - 1) < 0.05, name
    assert torch.equal(p["shared_w3"], p["shared_w1"])     # the reference's quirk
    assert tuple(p["w1"].shape) == (cfg.num_layers, cfg.num_experts, d, f)


def test_prefill_logits_match(case):
    toks = C.tokens(case["cfg"], B, T)
    got = TT.forward(case["model"], torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), C.ref_prefill(case, toks), **C.LOGIT_TOL)


def test_decode_steps_match(case):
    """24 decode steps against the reference's: logits at every step and the
    KV cache at the end. Mixtral's cache is its 16-slot window ring, which
    the 24 positions wrap: positions 16-23 sit in slots 0-7."""
    toks = C.tokens(case["cfg"], B, T)
    want, jcache = C.ref_decode(case, toks, max_len=32)
    got, cache = C.port_decode(case, toks, max_len=32)
    np.testing.assert_allclose(got, want, **C.LOGIT_TOL)
    C.assert_kv_matches(cache, jcache["kv"])
    if case["cfg"].sliding_window:
        window = case["cfg"].sliding_window
        assert cache.k.shape[2] == window == 16
        slots = np.arange(window)
        np.testing.assert_array_equal(cache.pos[0, 0].numpy(),
                                      np.where(slots < T - window, slots + window, slots))


def test_decode_matches_prefill(case):
    """tests/test_arch_smoke.py:69's contract: drops off (capacity factor
    100), decode equals prefill; no kernel on the CPU."""
    case = C.pair(case["cfg"].name.removesuffix("-reduced"), moe_capacity_factor=100.0)
    toks = torch.from_numpy(C.tokens(case["cfg"], B, T))
    cache = TT.init_cache(case["cfg"], B, 32, dtype=torch.float32, device="cpu")
    ops.reset_launch_counts()
    dec = serve_lm.decode(case["model"], cache, toks)
    assert ops.launch_counts()["flash_decode"] == 0
    np.testing.assert_allclose(dec.numpy(), TT.forward(case["model"], toks).numpy(),
                               **C.LOGIT_TOL)


def test_loss_grads_and_one_step_match(case):
    C.assert_training_matches(case, C.ref_training(case), GRAD_TOL)


def test_aux_loss_reaches_the_router_only_through_the_gates(case):
    """The kept fraction is built from one-hots: the aux loss's gradient is
    the router's alone, and it is the reference's."""
    p, tp, x = _moe_inputs(case, 2, 24, seed=4)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    _, aux = tmoe.moe_ffn(tp, xt, case["cfg"])
    aux.backward()
    assert all(v.grad is None or not v.grad.any() for k, v in tp.items() if k != "router")
    jgrad = jax.grad(lambda r, x: jmoe.moe_ffn({**jax.tree.map(jnp.asarray, p), "router": r},
                                               x, case["jcfg"])[1])(
        jnp.asarray(p["router"]), jnp.asarray(x))
    np.testing.assert_allclose(tp["router"].grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)


def test_entry_points_on_cpu(case, capsys):
    arch = case["cfg"].name.removesuffix("-reduced")
    serve_lm.main(["--arch", arch, "--device", "cpu", "--reduced", "--batch", "3",
                   "--tokens", "20", "--max-len", "24"])
    lm_train.main(["--arch", arch, "--device", "cpu", "--steps", "3", "--batch", "2",
                   "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert "decoded 20 positions x 3 sequences" in out[0] and "finite: True" in out[1]
    assert out[3] == "  flash_decode launches: 0"
    assert out[4].startswith(f"{case['cfg'].name}: 2L d=64")
    assert [ln.split(" loss ")[0] for ln in out[5:]] == ["  step    0", "  step    2"]
    assert all(np.isfinite(float(ln.split(" loss ")[1])) for ln in out[5:])
