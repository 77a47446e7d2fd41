"""Port vs reference: dense-family LM training (``repro_torch.models.
transformer`` ``loss_fn`` / ``forward(mode="train")`` and
``repro_torch.lm_train`` vs ``repro.models.transformer`` and
``examples/lm_train.py``) on the reduced smollm-135m and qwen1.5-0.5b, from
the reference's weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import TrainState as JTrainState
from repro.optim import make_train_step as jmake_train_step
from repro_torch import lm_train
from repro_torch.configs import get_config
from repro_torch.data import make_lm_batch
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamW, TrainState, make_train_step
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.tree import leaves, tree_map

ARCHS = ["smollm-135m", "qwen1.5-0.5b"]
# measured: loss equal, grads 6.9e-7 apart at most (1.2e-6 of a leaf's largest)
GRAD_TOL = dict(rtol=1e-5, atol=2e-6)
# one AdamW step from zero moments moves a param by lr * g / (|g| + eps):
# where |g| is near eps (3e-9 on one element here) the grads' relative gap
# is amplified, to 1.2e-5 measured; the moments, linear in g, are not
STEP_PARAM_TOL = dict(rtol=0, atol=1e-4)
B, S = 2, 32


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The reduced config of both packages, the reference's params and
    batch as numpy, its loss and grads, and its state after one AdamW step."""
    arch = request.param
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    raw = make_lm_batch(cfg.vocab_size, B, S, seed=0, step=0)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, jcfg)))(params, jb)
    opt = JAdamW(lr=1e-3)
    stepped, m = jax.jit(jmake_train_step(lambda p, b: JT.loss_fn(p, b, jcfg), opt))(
        JTrainState(params, opt), jb)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return {"arch": arch, "cfg": cfg, "params": to_np(params), "raw": raw, "loss": float(loss),
            "grads": to_np(grads), "stepped": to_np(stepped), "step_loss": float(m["loss"])}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _loss(cfg):
    return lambda p, b: TT.loss_fn(p, b, cfg)


def test_loss_and_grads_match_reference(case):
    loss, grads = value_and_grad(_loss(case["cfg"]), _t(case["params"]), _batch(case["raw"]))
    assert abs(float(loss) - case["loss"]) < 1e-6
    want = jax.tree.leaves(case["grads"])
    got = leaves(grads)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), a, **GRAD_TOL)


def test_remat_gives_the_same_grads(case, monkeypatch):
    p, b = _t(case["params"]), _batch(case["raw"])
    l1, g1 = value_and_grad(_loss(case["cfg"]), p, b)
    with monkeypatch.context() as m:    # no remat: each group runs as it is
        m.setattr(TT, "checkpoint", lambda f, *a, **k: f(*a))
        l2, g2 = value_and_grad(_loss(case["cfg"]), p, b)
    assert torch.equal(l1, l2)
    assert all(torch.equal(x, y) for x, y in zip(leaves(g1), leaves(g2)))
    span = dataclasses.replace(case["cfg"], remat_span=2)      # one 2-layer group
    l3, g3 = value_and_grad(_loss(span), p, b)
    assert torch.equal(l1, l3)
    assert all(torch.equal(x, y) for x, y in zip(leaves(g1), leaves(g3)))


def test_train_forward_on_the_module(case):
    """``forward(model, mode="train")`` on an ``LM`` keeps autograd; prefill
    gives the same logits under ``no_grad``."""
    model = TT.params_from_jax(TT.LM(case["cfg"], device="cpu"), case["params"])
    tokens = torch.from_numpy(case["raw"]["tokens"])
    logits = TT.forward(model, tokens, mode="train")
    assert logits.requires_grad
    logits.sum().backward()
    assert model.blocks[0].attn["wq"].grad is not None
    prefill = TT.forward(model, tokens)
    assert not prefill.requires_grad
    torch.testing.assert_close(prefill, logits.detach(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        TT.forward(model, tokens, mode="decode")


def test_one_adamw_step_matches_reference(case):
    opt = AdamW(lr=1e-3)
    params = _t(case["params"])
    state, m = make_train_step(_loss(case["cfg"]), opt)(TrainState(params, opt),
                                                        _batch(case["raw"]))
    assert abs(float(m["loss"]) - case["step_loss"]) < 1e-6
    assert int(state["step"]) == 1
    for part, tol in (("params", STEP_PARAM_TOL), ("opt", GRAD_TOL)):
        want = jax.tree.leaves(case["stepped"][part])
        got = leaves(state[part])
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), a, **tol)


def test_same_batch_descends(case):
    """tests/test_arch_smoke.py:51's contract: 5 steps on one batch."""
    opt = AdamW(lr=2e-3)
    state = TrainState(_t(case["params"]), opt)
    step = make_train_step(_loss(case["cfg"]), opt)
    losses = []
    for _ in range(5):
        state, m = step(state, _batch(case["raw"]))
        assert torch.isfinite(m["loss"])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def _keep(into):
    """A ``grad_transform`` that records the step's grads (before clipping)."""
    def keep(grads):
        into.append(grads)
        return grads
    return keep


def test_microbatched_step_matches_plain(case):
    """tests/test_arch_smoke.py:97's contract, at lr 1e-4 and batch 4; the
    accumulated grads also match the plain step's (a one-step param gap
    alone would pass for any gradient)."""
    opt = AdamW(lr=1e-4)
    raw = make_lm_batch(case["cfg"].vocab_size, 4, S, seed=1, step=0)
    g1, g2 = [], []
    s1, m1 = make_train_step(_loss(case["cfg"]), opt, grad_transform=_keep(g1))(
        TrainState(_t(case["params"]), opt), _batch(raw))
    s2, m2 = make_train_step(_loss(case["cfg"]), opt, microbatches=2,
                             grad_transform=_keep(g2))(
        TrainState(_t(case["params"]), opt), _batch(raw))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    for a, b in zip(leaves(s1["params"]), leaves(s2["params"])):
        assert float((a - b).abs().max()) < 1e-3
    for a, b in zip(leaves(g1[0]), leaves(g2[0])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **GRAD_TOL)


def test_microbatched_step_matches_reference(case):
    """microbatches=2 against the reference's (``lax.scan``) at batch 4: loss,
    pre-clip grad norm and moments (linear in the grads) at the grads'
    tolerance, params at one step's."""
    jcfg = jget_config(case["arch"]).reduced()
    raw = make_lm_batch(case["cfg"].vocab_size, 4, S, seed=1, step=0)
    jopt, opt = JAdamW(lr=1e-4), AdamW(lr=1e-4)
    jparams = jax.tree.map(jnp.asarray, case["params"])
    js, jm = jax.jit(jmake_train_step(lambda p, b: JT.loss_fn(p, b, jcfg), jopt,
                                      microbatches=2))(
        JTrainState(jparams, jopt), {k: jnp.asarray(v) for k, v in raw.items()})
    ts, tm = make_train_step(_loss(case["cfg"]), opt, microbatches=2)(
        TrainState(_t(case["params"]), opt), _batch(raw))
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-6
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    for part, tol in (("params", STEP_PARAM_TOL), ("opt", GRAD_TOL)):
        want = jax.tree.leaves(js[part])
        got = leaves(ts[part])
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


def test_lm_train_entry_point_on_cpu(capsys):
    lm_train.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    cfg = get_config("smollm-135m").reduced()
    assert out[0] == (f"{cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
                      f"({cfg.param_count()/1e6:.1f}M params)")
    assert [ln.split(" loss ")[0] for ln in out[1:]] == ["  step    0", "  step    2"]
    assert all(np.isfinite(float(ln.split(" loss ")[1])) for ln in out[1:])


@pytest.mark.parametrize("family", ["vlm", "encoder"])
def test_other_families_raise_naming_item_6(family):
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), family=family)
    params = TT.init_params(get_config("smollm-135m").reduced(), torch.Generator())
    batch = _batch(make_lm_batch(256, 1, 4, seed=0, step=0))
    for call in (lambda: TT.loss_fn(params, batch, cfg),
                 lambda: lm_train.build(cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="item 6"):
            call()
