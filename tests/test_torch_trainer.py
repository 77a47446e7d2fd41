"""Port vs reference: the fault-tolerant trainer, the checkpoint manager and
the synthetic data (``repro_torch.runtime.trainer``,
``repro_torch.checkpoint``, ``repro_torch.data`` vs the ``repro`` ones):
``tests/test_runtime.py``'s contracts on the port, checkpoints restored
across the two packages both ways, batches bit for bit, and the
``train_dlrm`` entry point on the CPU."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import dlrm_batch_stream as jdlrm_batch_stream
from repro.data import make_dlrm_batch as jmake_dlrm_batch
from repro.data import make_lm_batch as jmake_lm_batch
from repro.models import dlrm as jdlrm
from repro.optim import AdamW as JAdamW
from repro.optim import TrainState as JTrainState
from repro.optim import make_train_step as jmake_train_step
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch import lm_train, train_dlrm
from repro_torch.checkpoint import (CheckpointManager, incremental_embedding_update,
                                    latest_step)
from repro_torch.data import dlrm_batch_stream, make_dlrm_batch, make_lm_batch
from repro_torch.models import dlrm as tdlrm
from repro_torch.optim import AdamW, TrainState, make_train_step
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.tree import leaves, tree_map

ARCH_FIELDS = dict(user_tables=(400,) * 3, item_tables=(400,) * 2, embed_dim=8,
                   bottom_mlp=(16, 8), top_mlp=(16, 1), pooling=4)  # tests/test_runtime.py
JARCH, TARCH = jdlrm.DLRMArch(**ARCH_FIELDS), tdlrm.DLRMArch(**ARCH_FIELDS)
STEP_TOL = 1e-6        # tests/test_torch_optim.py: 24 steps track within 1.2e-7


def _make(tmpdir, total=24, failure_hook=None):
    """``tests/test_runtime.py``'s trainer on the port (its own weights)."""
    params = tdlrm.init_params(TARCH, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-3)
    step = make_train_step(lambda p, b: tdlrm.loss_fn(p, b, TARCH), opt)
    cfg = TrainerConfig(total_steps=total, ckpt_every=8, ckpt_dir=str(tmpdir))
    return Trainer(step, TrainState(params, opt),
                   lambda s0: dlrm_batch_stream(TARCH, 16, seed=0, start_step=s0),
                   cfg, failure_hook=failure_hook)


def _jmake(tmpdir, total):
    params = jdlrm.init_params(JARCH, jax.random.PRNGKey(0))
    opt = JAdamW(lr=1e-3)
    step = jax.jit(jmake_train_step(lambda p, b: jdlrm.loss_fn(p, b, JARCH), opt))
    cfg = JTrainerConfig(total_steps=total, ckpt_every=8, ckpt_dir=str(tmpdir))
    return JTrainer(step, JTrainState(params, opt),
                    lambda s0: jdlrm_batch_stream(JARCH, 16, seed=0, start_step=s0), cfg)


# ---------------------------------------------------------------------------
# tests/test_runtime.py's contracts on the port
# ---------------------------------------------------------------------------


def test_crash_restart_bitwise_resume(tmp_path):
    class Boom(RuntimeError):
        pass

    def fail_once(step):
        if step == 13 and not getattr(fail_once, "fired", False):
            fail_once.fired = True
            raise Boom()

    t1 = _make(tmp_path / "a", failure_hook=fail_once)
    with pytest.raises(Boom):
        t1.run()
    assert latest_step(str(tmp_path / "a")) == 8
    t2 = _make(tmp_path / "a")
    out = t2.run()
    assert out["final_step"] == 24 and out["metrics"][0]["step"] == 8

    ref = _make(tmp_path / "b")
    ref.run()
    for a, b in zip(leaves(t2.state), leaves(ref.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(4.0), "step": torch.tensor(0)}
    for s in (1, 2, 3):
        mgr.save(state, s)
    (tmp_path / "step_9.tmp").mkdir()           # a save that crashed mid-way
    assert latest_step(str(tmp_path)) == 3
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert "step_1" not in kept  # gc'd
    restored, step = mgr.restore(state)
    assert step == 3
    assert torch.equal(restored["w"], torch.arange(4.0))
    assert CheckpointManager(str(tmp_path / "empty")).restore(state) == (None, None)


def test_restore_onto_given_devices(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(8.0), "opt": [torch.ones(2, 3)]}
    mgr.save(state, 5)
    devices = tree_map(lambda _: torch.device("cpu"), state)
    restored, step = mgr.restore(state, devices=devices)
    assert step == 5 and restored["w"].device == torch.device("cpu")
    assert torch.equal(restored["opt"][0], torch.ones(2, 3))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(4), "opt": [torch.ones(2, 3)]})
    t = _make(tmp_path / "t", total=2)
    moved = t.reshard_for(tree_map(lambda _: torch.device("cpu"), t.state))
    assert all(x.device.type == "cpu" for x in leaves(moved))


def test_incremental_embedding_update(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"t": torch.zeros(4)}, 1)
    path = incremental_embedding_update(str(tmp_path), 1,
                                        {"table_0": torch.ones((4, 2)),
                                         "table_1": np.arange(6.0).reshape(3, 2)},
                                        update_id=7)
    assert "emb_update_7" in path and not path.endswith(".tmp")
    np.testing.assert_array_equal(np.load(f"{path}/table_0.npy"), np.ones((4, 2), np.float32))
    np.testing.assert_array_equal(np.load(f"{path}/table_1.npy"), np.arange(6.0).reshape(3, 2))
    assert latest_step(str(tmp_path)) == 1


def test_straggler_detection(tmp_path, monkeypatch):
    """The trainer's clock is a fake one that each step advances by 10 ms,
    and by 250 ms more at step 14: a wall clock shared with other test
    processes moves the median step, and with it the ratio."""
    t = _make(tmp_path, total=16)
    seen = []
    t.straggler_hook = lambda step, ratio: seen.append((step, ratio))
    slow = {14}
    clock = [0.0]
    monkeypatch.setattr(trainer_mod, "time", SimpleNamespace(perf_counter=lambda: clock[0]))

    orig = t.step_fn

    def slow_step(state, batch):
        clock[0] += 0.010 + (0.25 if int(state["step"]) in slow else 0.0)
        return orig(state, batch)
    t.step_fn = slow_step
    out = t.run(resume=False)
    assert out["stragglers"], "slow step not detected"
    assert any(step == 14 and ratio > 3.0 for step, ratio in seen)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def test_port_resumes_reference_checkpoint(tmp_path):
    """The reference trains 8 steps and saves; the port restores and runs to
    24, within ``STEP_TOL`` of the reference's own 24 steps."""
    _jmake(tmp_path / "a", 8).run()
    ref = _jmake(tmp_path / "b", 24)
    ref.run()
    t = _make(tmp_path / "a", total=24)
    assert t.try_restore() == 8
    assert int(t.state["step"]) == 8 and t.state["step"].dtype == torch.int32
    out = t.run()
    assert out["final_step"] == 24 and len(out["metrics"]) == 16
    for a, b in zip(jax.tree.leaves(ref.state), leaves(t.state)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=STEP_TOL)


def test_reference_restores_port_checkpoint(tmp_path):
    """The port trains and saves; the reference's ``CheckpointManager``
    restores the tree bit for bit, on the reference's key paths."""
    t = _make(tmp_path, total=5)
    t.run()
    like = JTrainState(jdlrm.init_params(JARCH, jax.random.PRNGKey(1)), JAdamW())
    restored, step = JCheckpointManager(str(tmp_path)).restore(like)
    assert step == 5
    jl = jax.tree.leaves(restored)
    tl = leaves(t.state)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# data and the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 13), (3, 1), (7, 250)])
def test_batches_bit_equal(seed, step):
    got, want = make_dlrm_batch(TARCH, 16, seed=seed, step=step), \
        jmake_dlrm_batch(JARCH, 16, seed=seed, step=step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    got, want = make_lm_batch(256, 4, 32, seed=seed, step=step), \
        jmake_lm_batch(256, 4, 32, seed=seed, step=step)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_train_dlrm_entry_point_on_cpu(tmp_path, monkeypatch, capsys):
    """The example's lines, at the test arch (the example's 96.3M-parameter
    arch is for the card)."""
    assert train_dlrm.ARCH.param_count() == 96_342_849
    monkeypatch.setattr(train_dlrm, "ARCH", TARCH)
    argv = ["--device", "cpu", "--steps", "2", "--batch", "8", "--ckpt", str(tmp_path)]
    train_dlrm.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"DLRM params: {TARCH.param_count()/1e6:.1f}M "
                      f"({TARCH.num_tables} tables x dim {TARCH.embed_dim})")
    assert out[-1].startswith("loss: first10=") and out[-1].endswith("steps=2 stragglers=0")
    train_dlrm.main(["--device", "cpu", "--steps", "3", "--batch", "8", "--ckpt",
                     str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert "resuming from checkpoint at step 2" in out and out[-1].endswith("steps=3 stragglers=0")


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_dlrm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tdlrm.init_params(TARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdlrm.state_from_jax(jax.tree.map(np.asarray, JTrainState(
            jdlrm.init_params(JARCH, jax.random.PRNGKey(0)), JAdamW())), TARCH)
