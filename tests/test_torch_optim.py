"""Port vs reference: the optimizers, the schedule, the train step and the
int8 gradient compression (``repro_torch.optim`` vs ``repro.optim``), on
the same numpy inputs; the DLRM train step on ``tests/test_runtime.py``'s
arch from the reference's own initial state (``state_from_jax``)."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_dlrm_batch as jmake_dlrm_batch
from repro.models import dlrm as jdlrm
from repro.optim import AdamW as JAdamW
from repro.optim import SGD as JSGD
from repro.optim import TrainState as JTrainState
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import global_norm as jglobal_norm
from repro.optim import make_train_step as jmake_train_step
from repro.optim.compression import compress_int8 as jcompress
from repro_torch.data import make_dlrm_batch
from repro_torch.models import dlrm as tdlrm
from repro_torch.optim import (SGD, AdamW, ErrorFeedbackState, TrainState,
                               clip_by_global_norm, compress_int8,
                               compressed_psum, cosine_schedule,
                               decompress_int8, global_norm, make_train_step)
from repro_torch.optim.optimizers import value_and_grad
from repro_torch.tree import leaves, tree_map

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
ARCH_FIELDS = dict(user_tables=(400,) * 3, item_tables=(400,) * 2, embed_dim=8,
                   bottom_mlp=(16, 8), top_mlp=(16, 1), pooling=4)  # tests/test_runtime.py
JARCH, TARCH = jdlrm.DLRMArch(**ARCH_FIELDS), tdlrm.DLRMArch(**ARCH_FIELDS)
# measured: one AdamW update differs from XLA's fused one by an ulp (max rel 3.0e-7)
UPDATE_TOL = dict(rtol=1e-6, atol=0)
# measured over 24 steps: 1.2e-7 on the loss, 6e-8 on any leaf
STEP_TOL = 1e-6
# int8 psum under jit: XLA fuses the residual's multiply-subtract on some
# shapes and sums the 4 scaled replicas in its own order (measured: sums
# 2.4e-7 apart at magnitudes up to 12, residuals 1.0e-7)
PSUM_TOL = dict(rtol=1e-6, atol=1e-6)
BATCH = 16


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(jtree, ttree, **tol):
    jl = jax.tree.leaves(jtree)
    tl = leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


# ---------------------------------------------------------------------------
# schedule, norms, updates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base_lr,warmup,total", [(2e-3, 50, 300), (1e-3, 0, 120),
                                                  (3e-4, 10, 100), (2e-3, 50, 40),
                                                  (1e-3, 7, 7)])
def test_cosine_schedule_bit_equal(base_lr, warmup, total):
    j, t = jcosine(base_lr, warmup, total), cosine_schedule(base_lr, warmup, total)
    for s in range(301):
        want = np.asarray(j(jnp.asarray(s, jnp.int32)))
        got = t(torch.tensor(s, dtype=torch.int32)).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), s


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip(max_norm):
    tree = _tree(np.random.default_rng(0), SHAPES)
    np.testing.assert_allclose(global_norm(_t(tree)).numpy(),
                               np.asarray(jglobal_norm(tree)), rtol=1e-6)
    jc, jn = jclip(tree, max_norm)
    tc, tn = clip_by_global_norm(_t(tree), max_norm)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    _close(jc, tc, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("lr", ["const", "cosine"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamw_update_matches(lr, weight_decay):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng, SHAPES), _tree(rng, SHAPES)
    state = {"m": _tree(rng, SHAPES),
             "v": tree_map(lambda x: np.abs(x), _tree(rng, SHAPES))}
    step = 7
    j = JAdamW(lr=1e-3 if lr == "const" else jcosine(2e-3, 5, 20), weight_decay=weight_decay)
    t = AdamW(lr=1e-3 if lr == "const" else cosine_schedule(2e-3, 5, 20),
              weight_decay=weight_decay)
    ju, jo = j.update(grads, state, params, jnp.asarray(step, jnp.int32))
    tu, to = t.update(_t(grads), _t(state), _t(params), torch.tensor(step, dtype=torch.int32))
    _close(ju, tu, **UPDATE_TOL)
    _close(jo, to, **UPDATE_TOL)
    assert set(to) == {"m", "v"}


def test_sgd_update_matches():
    rng = np.random.default_rng(2)
    params, grads, mom = _tree(rng, SHAPES), _tree(rng, SHAPES), _tree(rng, SHAPES)
    ju, jo = JSGD(lr=1e-2).update(grads, {"mom": mom}, params, jnp.asarray(3, jnp.int32))
    tu, to = SGD(lr=1e-2).update(_t(grads), {"mom": _t(mom)}, _t(params),
                                 torch.tensor(3, dtype=torch.int32))
    _close(ju, tu, **UPDATE_TOL)
    _close(jo, to, **UPDATE_TOL)


def test_train_state_layout():
    params = _t(_tree(np.random.default_rng(3), SHAPES))
    state = TrainState(params, AdamW())
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    for m in leaves(state["opt"]):
        assert m.dtype == torch.float32 and not m.any()
    assert sorted(TrainState(params, SGD())["opt"]) == ["mom"]


# ---------------------------------------------------------------------------
# the DLRM train step
# ---------------------------------------------------------------------------


def _dlrm_states():
    """The reference's initial AdamW state and the port's copy of it."""
    params = jdlrm.init_params(JARCH, jax.random.PRNGKey(0))
    jstate = JTrainState(params, JAdamW(lr=1e-3))
    return jstate, tdlrm.state_from_jax(_np(jstate), TARCH, device="cpu")


def _batches(step):
    b, jb = make_dlrm_batch(TARCH, BATCH, seed=0, step=step), \
        jmake_dlrm_batch(JARCH, BATCH, seed=0, step=step)
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_dlrm_one_step_loss_grads_params():
    jstate, tstate = _dlrm_states()
    jb, tb = _batches(0)
    jl, jg = jax.value_and_grad(lambda p: jdlrm.loss_fn(p, jb, JARCH))(jstate["params"])
    tl, tg = value_and_grad(lambda p, b: tdlrm.loss_fn(p, b, TARCH), tstate["params"], tb)
    assert abs(float(jl) - float(tl)) < STEP_TOL
    _close(jg, tg, rtol=0, atol=STEP_TOL)
    jnew, jm = jax.jit(jmake_train_step(lambda p, b: jdlrm.loss_fn(p, b, JARCH),
                                        JAdamW(lr=1e-3)))(jstate, jb)
    tnew, tm = make_train_step(lambda p, b: tdlrm.loss_fn(p, b, TARCH),
                               AdamW(lr=1e-3))(tstate, tb)
    assert abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) < STEP_TOL
    _close(jnew, tnew, rtol=0, atol=STEP_TOL)
    assert int(tnew["step"]) == 1 and int(tstate["step"]) == 0   # the input state is kept


def test_dlrm_24_steps_track_reference():
    jstate, tstate = _dlrm_states()
    jstep = jax.jit(jmake_train_step(lambda p, b: jdlrm.loss_fn(p, b, JARCH), JAdamW(lr=1e-3)))
    tstep = make_train_step(lambda p, b: tdlrm.loss_fn(p, b, TARCH), AdamW(lr=1e-3))
    for s in range(24):
        jb, tb = _batches(s)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert abs(float(jm["loss"]) - float(tm["loss"])) < STEP_TOL, s
    _close(jstate, tstate, rtol=0, atol=STEP_TOL)


def test_dlrm_microbatches_2_match_reference():
    """Both split every batch leaf on its leading dim, so the indices go
    batch-major ([B, T, P]) and each loss puts them back to [T, B, P]."""
    jstate, tstate = _dlrm_states()
    jloss = lambda p, b: jdlrm.loss_fn(   # noqa: E731
        p, {**b, "indices": jnp.swapaxes(b["indices"], 0, 1)}, JARCH)
    tloss = lambda p, b: tdlrm.loss_fn(   # noqa: E731
        p, {**b, "indices": b["indices"].transpose(0, 1)}, TARCH)
    jstep = jax.jit(jmake_train_step(jloss, JAdamW(lr=1e-3), microbatches=2))
    tstep = make_train_step(tloss, AdamW(lr=1e-3), microbatches=2)
    plain = make_train_step(tloss, AdamW(lr=1e-3))
    jb, tb = _batches(0)
    jb = {**jb, "indices": jnp.swapaxes(jb["indices"], 0, 1)}
    tb = {**tb, "indices": tb["indices"].transpose(0, 1).contiguous()}
    jnew, jm = jstep(jstate, jb)
    tnew, tm = tstep(tstate, tb)
    assert abs(float(jm["loss"]) - float(tm["loss"])) < STEP_TOL
    _close(jnew, tnew, rtol=0, atol=STEP_TOL)
    pnew, pm = plain(tstate, tb)
    assert abs(float(pm["loss"]) - float(tm["loss"])) < 1e-5
    for a, b in zip(leaves(pnew["params"]), leaves(tnew["params"])):
        assert float((a - b).abs().max()) < 1e-3    # tests/test_arch_smoke.py:114-119


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["normal", "tiny", "zeros", "ties"])
def test_compress_int8_bit_equal(case):
    rng = np.random.default_rng(4)
    x = {"normal": rng.standard_normal(1000).astype(np.float32),
         "tiny": (rng.standard_normal((20, 30)) * 1e-30).astype(np.float32),
         "zeros": np.zeros(17, np.float32),
         "ties": (np.arange(-254, 255, dtype=np.float32) / 2.0)}[case]
    jq, js = jcompress(jnp.asarray(x))
    tq, ts = compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def test_int8_roundtrip_and_error_feedback():
    """``tests/test_runtime.py``'s contract on the port."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, s = compress_int8(x)
    assert float((x - decompress_int8(q, s)).abs().max()) <= float(s) * 0.5 + 1e-6
    ef = ErrorFeedbackState({"g": x})["g"]
    gc = x + ef
    q2, s2 = compress_int8(gc)
    new_ef = gc - decompress_int8(q2, s2)
    assert float(new_ef.abs().mean()) < float(x.abs().mean())


PSUM_REPLICAS = 4
PSUM_SHAPES = {"w": (6, 5), "b": (5,), "t": (40, 3)}


def _psum_inputs():
    rng = np.random.default_rng(5)
    grads = {k: rng.standard_normal((PSUM_REPLICAS,) + s).astype(np.float32)
             for k, s in PSUM_SHAPES.items()}
    efs = {k: (0.01 * rng.standard_normal((PSUM_REPLICAS,) + s)).astype(np.float32)
           for k, s in PSUM_SHAPES.items()}
    return grads, efs


def _psum_worker(out_path: str) -> None:
    """The reference's ``compressed_psum`` under ``shard_map`` over 4 forced
    host devices; writes each replica's sum and residual to ``out_path``."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_mesh_compat
    from repro.optim.compression import compressed_psum as jpsum

    mesh = make_mesh_compat((PSUM_REPLICAS,), ("dp",))
    grads, efs = _psum_inputs()
    spec = {k: P("dp") for k in PSUM_SHAPES}

    def body(g, e):
        return jpsum(g, "dp", e)
    sums, new_efs = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                      out_specs=(spec, spec), check_rep=False))(grads, efs)
    np.savez(out_path, **{f"sum_{k}": np.asarray(v) for k, v in sums.items()},
             **{f"ef_{k}": np.asarray(v) for k, v in new_efs.items()})


def test_compressed_psum_matches_shard_map(tmp_path):
    out = tmp_path / "psum.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={PSUM_REPLICAS}")
    code = (f"import sys; sys.path.insert(0, {str(HERE)!r})\n"
            "import test_torch_optim as m\n"
            f"m._psum_worker({json.dumps(str(out))})\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=HERE,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    grads, efs = _psum_inputs()
    tg = [{k: torch.from_numpy(v[r]) for k, v in grads.items()} for r in range(PSUM_REPLICAS)]
    te = [{k: torch.from_numpy(v[r]) for k, v in efs.items()} for r in range(PSUM_REPLICAS)]
    sums, new_efs = compressed_psum(tg, te)
    assert len(sums) == len(new_efs) == PSUM_REPLICAS
    for r in range(PSUM_REPLICAS):
        for k in PSUM_SHAPES:
            np.testing.assert_allclose(sums[r][k].numpy(), ref[f"sum_{k}"][r], **PSUM_TOL)
            np.testing.assert_allclose(new_efs[r][k].numpy(), ref[f"ef_{k}"][r], **PSUM_TOL)
    # every replica holds the same sum, near the uncompressed one
    for k in PSUM_SHAPES:
        for r in range(1, PSUM_REPLICAS):
            assert torch.equal(sums[r][k], sums[0][k])
        exact = (grads[k] + efs[k]).sum(axis=0)
        assert np.abs(sums[0][k].numpy() - exact).max() < 0.1

