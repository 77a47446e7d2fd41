"""Shared set-up of the LM family parity tests (``tests/test_torch_moe.py``,
``test_torch_ssd.py``, ``test_torch_hybrid.py``): a reduced config of both
packages, the reference's weights as numpy loaded into the port's ``LM``,
and the reference's prefill, decode and loss/grads on the same numpy
inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import TrainState as JTrainState
from repro.optim import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.data import make_lm_batch
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamW, TrainState, make_train_step
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.tree import leaves, tree_map

LOGIT_TOL = dict(rtol=0, atol=5e-5)           # tests/test_arch_smoke.py:90
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
# one AdamW step from zero moments moves a param by lr * g / (|g| + eps):
# tests/test_torch_lm_train.py's tolerance for the params, the grads' for m, v
STEP_PARAM_TOL = dict(rtol=0, atol=1e-4)


def configs(arch: str, **replace):
    """(reference cfg, port cfg): ``arch``'s reduced config, fields replaced."""
    return (dataclasses.replace(jget_config(arch).reduced(), **replace),
            dataclasses.replace(get_config(arch).reduced(), **replace))


def pair(arch: str, **replace) -> dict:
    """Both configs, the reference's params (numpy) and the port's ``LM`` on
    the CPU loaded from them."""
    jcfg, cfg = configs(arch, **replace)
    params = jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    model = TT.params_from_jax(TT.LM(cfg, device="cpu"), params)
    return {"jcfg": jcfg, "cfg": cfg, "params": params, "model": model}


def tokens(cfg, B: int, T: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def ref_prefill(case, toks) -> np.ndarray:
    logits, _, _ = JT.forward(jax.tree.map(jnp.asarray, case["params"]),
                              {"tokens": jnp.asarray(toks)}, case["jcfg"], mode="prefill")
    return np.asarray(logits)


def ref_decode(case, toks, max_len: int):
    """The reference's decode_step over every position, f32 cache: (logits
    [B, T, V], the final cache as numpy)."""
    jparams = jax.tree.map(jnp.asarray, case["params"])
    step = jax.jit(JT.decode_step, static_argnums=3)
    cache = JT.init_cache(case["jcfg"], toks.shape[0], max_len=max_len, dtype=jnp.float32)
    out = []
    for t in range(toks.shape[1]):
        lg, cache = step(jparams, cache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                          "pos": jnp.array(t, jnp.int32)}, case["jcfg"])
        out.append(np.asarray(lg))
    return np.concatenate(out, axis=1), jax.tree.map(np.asarray, cache)


def port_decode(case, toks, max_len: int):
    """The port's decode_step over every position, f32 cache: (logits
    [B, T, V], the cache)."""
    model = case["model"]
    cache = TT.init_cache(case["cfg"], toks.shape[0], max_len, dtype=torch.float32,
                          device="cpu")
    out = []
    for t in range(toks.shape[1]):
        lg, cache = TT.decode_step(model, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        out.append(lg.numpy())
    return np.concatenate(out, axis=1), cache


def assert_kv_matches(kv, ref_kv) -> None:
    np.testing.assert_array_equal(kv.pos.numpy(), ref_kv["pos"])
    np.testing.assert_array_equal(kv.valid.numpy(), ref_kv["valid"])
    np.testing.assert_allclose(kv.k.numpy(), ref_kv["k"], **CACHE_TOL)
    np.testing.assert_allclose(kv.v.numpy(), ref_kv["v"], **CACHE_TOL)


def assert_ssd_matches(ssd, ref_ssd) -> None:
    for name in ("state", "conv_x", "conv_b", "conv_c"):
        np.testing.assert_allclose(getattr(ssd, name).numpy(), ref_ssd[name], **CACHE_TOL,
                                   err_msg=name)


def batch(raw) -> dict:
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def as_torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def ref_training(case, B: int = 2, S: int = 32) -> dict:
    """The reference's loss and grads on ``make_lm_batch(seed 0, step 0)``
    and its state after one AdamW step at 1e-3, as numpy."""
    jcfg = case["jcfg"]
    raw = make_lm_batch(jcfg.vocab_size, B, S, seed=0, step=0)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jparams = jax.tree.map(jnp.asarray, case["params"])
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, jcfg)))(jparams, jb)
    opt = JAdamW(lr=1e-3)
    stepped, m = jax.jit(jmake_train_step(lambda p, b: JT.loss_fn(p, b, jcfg), opt))(
        JTrainState(jparams, opt), jb)
    return {"raw": raw, "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
            "stepped": jax.tree.map(np.asarray, stepped), "step_loss": float(m["loss"])}


def assert_training_matches(case, ref, grad_tol: dict) -> None:
    """The port's loss and grads, then one AdamW step, against ``ref``."""
    cfg = case["cfg"]
    loss_fn = lambda p, b: TT.loss_fn(p, b, cfg)   # noqa: E731
    loss, grads = value_and_grad(loss_fn, as_torch(case["params"]), batch(ref["raw"]))
    assert abs(float(loss) - ref["loss"]) < 1e-5
    want, got = jax.tree.leaves(ref["grads"]), leaves(grads)
    assert len(got) == len(want)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), a, **grad_tol)
    opt = AdamW(lr=1e-3)
    state, m = make_train_step(loss_fn, opt)(TrainState(as_torch(case["params"]), opt),
                                             batch(ref["raw"]))
    assert abs(float(m["loss"]) - ref["step_loss"]) < 1e-5
    for part, tol in (("params", STEP_PARAM_TOL), ("opt", grad_tol)):
        want, got = jax.tree.leaves(ref["stepped"][part]), leaves(state[part])
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), a, **tol)


def assert_every_leaf_loaded(case) -> None:
    """``params_from_jax`` filled every leaf of the model, and a leaf of a
    wrong shape or a missing one raises, naming it."""
    params, model = case["params"], case["model"]
    got = TT.tree_of(model)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, params))
    for a, b in zip(jax.tree.leaves(params), leaves(got)):
        np.testing.assert_array_equal(b.numpy(), a)
    n_stacked = len(jax.tree.leaves(params["blocks"]))
    n_other = len(jax.tree.leaves(params)) - n_stacked
    assert sum(1 for _ in model.parameters()) == n_stacked * case["cfg"].num_layers + n_other
    fresh = TT.LM(case["cfg"], device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        name = keys[-1]
        bad = jax.tree.map(lambda a: a, params)
        node = bad
        for k in keys[:-1]:
            node = node[k]
        node[name] = leaf[..., :-1] if leaf.shape[-1] > 1 else np.zeros(leaf.shape + (2,))
        try:
            TT.params_from_jax(fresh, bad)
        except ValueError as e:
            assert name in str(e), (keys, e)
        else:
            raise AssertionError(f"{keys}: a wrong shape loaded")
        del node[name]
        try:
            TT.params_from_jax(fresh, bad)
        except ValueError as e:
            assert keys[-2] in str(e) if len(keys) > 1 else "params" in str(e), (keys, e)
        else:
            raise AssertionError(f"{keys}: a missing leaf loaded")
