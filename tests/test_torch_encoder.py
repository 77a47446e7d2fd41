"""Port vs reference: the encoder family (the encoder branch of
``repro_torch.models.transformer`` vs ``repro.models.transformer``) on the
reduced hubert-xlarge (2 bidirectional layers on frame embeddings, 4 heads
over 2 KV heads, a GELU MLP, no RoPE, no decode step), the reference's
weights loaded through ``params_from_jax``, the same numpy frames; and the
config copies of the two archs this family and the VLM brought, with
``ASSIGNED_ARCHS``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JASSIGNED
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import TrainState as JTrainState
from repro.optim import make_train_step as jmake_train_step
from repro_torch import lm_train, serve_lm
from repro_torch.configs import ASSIGNED_ARCHS, DECODE_ARCHS, get_config
from repro_torch.data import make_features
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamW, TrainState, make_train_step
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.tree import leaves

import torch_lm_cases as C

ARCH = "hubert-xlarge"
# loss and grads: measured loss gap 0 and grads 1.2e-7 apart at most (5.5e-7
# of the leaf's largest), as tests/test_torch_lm_train.py holds them
GRAD_TOL = dict(rtol=1e-5, atol=2e-6)
B, T = 2, 24


@pytest.fixture(scope="module")
def case():
    return C.pair(ARCH)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llama-3.2-vision-90b"])
def test_config_copy_agrees(arch):
    for t, j in ((get_config(arch), jget_config(arch)),
                 (get_config(arch).reduced(), jget_config(arch).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert (t.is_encoder_only, t.attn_free, t.subquadratic, t.skipped("decode_32k")) == \
            (j.is_encoder_only, j.attn_free, j.subquadratic, j.skipped("decode_32k"))


def test_assigned_archs_copy_agrees():
    assert ASSIGNED_ARCHS == JASSIGNED
    assert set(DECODE_ARCHS) == {a for a in ASSIGNED_ARCHS
                                 if get_config(a).family != "encoder"}
    assert all(TT.LM(get_config(a).reduced(), device="cpu").cfg.family in TT.FAMILIES
               for a in ASSIGNED_ARCHS)


def test_params_from_jax_checks_every_leaf(case):
    C.assert_every_leaf_loaded(case)
    assert "bq" not in case["params"]["blocks"]["attn"]
    assert set(case["params"]["blocks"]["mlp"]) == {"w1", "w2"}       # GELU, not gated


def test_prefill_logits_match(case):
    raw = C.inputs(case["cfg"], B, T)
    got = C.port_forward(case, raw)
    assert tuple(got.shape) == (B, T, case["cfg"].vocab_size)
    np.testing.assert_allclose(got.numpy(), C.ref_forward(case, raw), **C.LOGIT_TOL)


def test_attention_is_bidirectional_without_positions(case):
    """No causal mask: the last frame moves the first position's logits. No
    RoPE: permuting the frames permutes the logits, so the reference's
    prefill on permuted frames equals the port's, permuted back."""
    raw = C.inputs(case["cfg"], B, T)
    base = C.port_forward(case, raw)
    late = dict(raw, frames=raw["frames"].copy())
    late["frames"][:, -1] += 1.0
    assert float((C.port_forward(case, late)[:, 0] - base[:, 0]).abs().max()) > 1e-4
    perm = np.random.default_rng(1).permutation(T)
    shuffled = {"frames": np.ascontiguousarray(raw["frames"][:, perm])}
    np.testing.assert_allclose(C.port_forward(case, shuffled).numpy(),
                               base.numpy()[:, perm], rtol=0, atol=1e-5)
    np.testing.assert_allclose(C.port_forward(case, shuffled).numpy(),
                               C.ref_forward(case, shuffled), **C.LOGIT_TOL)


def test_decode_step_raises(case):
    cfg, model = case["cfg"], case["model"]
    with pytest.raises(ValueError, match="encoder-only model has no decode step"):
        TT.decode_step(model, TT.init_cache(cfg, B, 8, device="cpu"),
                       torch.zeros((B, 1), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="encoder-only"):
        JT.decode_step(jax.tree.map(jnp.asarray, case["params"]),
                       JT.init_cache(case["jcfg"], B, 8), {"tokens": jnp.zeros((B, 1), jnp.int32),
                                                            "pos": jnp.array(0)}, case["jcfg"])
    with pytest.raises(ValueError, match="frames"):
        TT.forward(model, torch.zeros((B, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="return_cache"):
        TT.forward(model, frames=torch.zeros((B, 4, cfg.d_model)), return_cache=True)


def test_loss_grads_and_one_step_match(case):
    """Loss, grads of every leaf (the embedding table's zero, as the
    reference's: frames bypass it) and one AdamW step."""
    ref = C.ref_training(case)
    assert "tokens" not in ref["raw"] and ref["raw"]["frames"].shape == (2, 32, 64)
    C.assert_training_matches(case, ref, GRAD_TOL)
    assert not ref["grads"]["embed"].any()
    _, grads = value_and_grad(lambda p, b: TT.loss_fn(p, b, case["cfg"]),
                              C.as_torch(case["params"]), C.batch(ref["raw"]))
    assert not grads["embed"].any()


def test_microbatched_step_matches_reference_and_plain(case):
    """microbatches=2 (the frames split on the batch axis with the labels)
    against the reference's at batch 4, and its accumulated grads against
    the plain step's."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    raw = {k: v.numpy() for k, v in lm_train.lm_batch(cfg, 4, 16, 1, "cpu").items()}
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
    """One checkpoint a block (``remat_span`` 1), a 2-block span and none
    at all give the same grads, bit for bit."""
    raw = {k: v.numpy() for k, v in lm_train.lm_batch(case["cfg"], 2, 16, 0, "cpu").items()}
    p, b = C.as_torch(case["params"]), C.batch(raw)
    assert TT._remat_span(case["cfg"]) == 1
    l1, g1 = value_and_grad(lambda p, b: TT.loss_fn(p, b, case["cfg"]), p, b)
    span = dataclasses.replace(case["cfg"], remat_span=2)
    l2, g2 = value_and_grad(lambda p, b: TT.loss_fn(p, b, span), p, b)
    with monkeypatch.context() as m:
        m.setattr(TT, "checkpoint", lambda f, *a, **k: f(*a))
        l3, g3 = value_and_grad(lambda p, b: TT.loss_fn(p, b, case["cfg"]), p, b)
    for loss, grads in ((l2, g2), (l3, g3)):
        assert torch.equal(l1, loss)
        assert all(torch.equal(x, y) for x, y in zip(leaves(g1), leaves(grads)))


def test_features_are_drawn_per_seed_and_step():
    a = make_features(2, 5, 8, seed=0, step=3, kind="frames")
    assert a.dtype == np.float32 and a.shape == (2, 5, 8)
    assert np.array_equal(a, make_features(2, 5, 8, seed=0, step=3, kind="frames"))
    for other in (dict(seed=1, step=3, kind="frames"), dict(seed=0, step=4, kind="frames"),
                  dict(seed=0, step=3, kind="images")):
        assert not np.array_equal(a, make_features(2, 5, 8, **other))


def test_entry_points_on_cpu(capsys):
    lm_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "2",
                   "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("hubert-xlarge-reduced: 2L d=64")
    assert [ln.split(" loss ")[0] for ln in out[1:]] == ["  step    0", "  step    2"]
    assert all(np.isfinite(float(ln.split(" loss ")[1])) for ln in out[1:])
    with pytest.raises(SystemExit):                   # no decode step to serve
        serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced"])
