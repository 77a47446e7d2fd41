"""Port vs reference: the DLRM (``repro_torch.models.dlrm`` vs
``repro.models.dlrm``), the serving slice as a whole (engine + scoring, as
``examples/serve_dlrm.py`` drives it), and the port's package rules."""
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import io_sim as jio
from repro.models import dlrm as jdlrm
from repro.runtime import engine as jeng
from repro_torch import serve_dlrm
from repro_torch.core import io_sim as tio
from repro_torch.models import dlrm as tdlrm
from repro_torch.runtime import engine as teng

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = dict(num_dense=5, embed_dim=16, user_tables=(120, 90, 150),
              item_tables=(80, 60), pooling=4, bottom_mlp=(32, 16),
              top_mlp=(24, 1))


@pytest.fixture(scope="module")
def pair():
    """Reference params (numpy) and the port's model loaded from them."""
    jarch, tarch = jdlrm.DLRMArch(**FIELDS), tdlrm.DLRMArch(**FIELDS)
    params = jax.tree_util.tree_map(
        np.asarray, jdlrm.init_params(jarch, jax.random.PRNGKey(0)))
    model = tdlrm.params_from_jax(tdlrm.DLRM(tarch, device="cpu"), params)
    return jarch, params, model


def _batch(arch, B, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, r, (B, arch.pooling))
                    for r in arch.all_tables]).astype(np.int32)
    return (rng.standard_normal((B, arch.num_dense)).astype(np.float32), idx,
            rng.integers(0, 2, B).astype(np.int32))


def test_arch_copy_agrees():
    for kw in ({}, FIELDS):
        j, t = jdlrm.DLRMArch(**kw), tdlrm.DLRMArch(**kw)
        assert (t.num_tables, t.all_tables, t.param_count()) == \
            (j.num_tables, j.all_tables, j.param_count())
    m = tdlrm.DLRM(tdlrm.DLRMArch(**FIELDS), device="cpu")
    assert sum(p.numel() for p in m.parameters()) == \
        tdlrm.DLRMArch(**FIELDS).param_count()


def test_params_from_jax_transposes_once(pair):
    _, params, model = pair
    for lin, p in zip(list(model.bottom) + list(model.top),
                      params["bottom"] + params["top"]):
        np.testing.assert_array_equal(lin.weight.detach().numpy(), p["w"].T)
        x = np.random.default_rng(0).standard_normal((3, p["w"].shape[0])
                                                     ).astype(np.float32)
        np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(),
                                   x @ p["w"] + p["b"], **TOL)
    for t, ref in zip(model.tables, params["tables"]):
        np.testing.assert_array_equal(t.detach().numpy(), ref)
    bad = dict(params, bottom=[{"w": p["w"].T, "b": p["b"]}
                               for p in params["bottom"]])
    with pytest.raises(ValueError):
        tdlrm.params_from_jax(tdlrm.DLRM(tdlrm.DLRMArch(**FIELDS), device="cpu"),
                              bad)


def test_interact_pair_order():
    for F in (2, 5, 13):
        iu, ju = np.asarray(jnp.triu_indices(F, k=1))
        t = torch.triu_indices(F, F, offset=1)
        np.testing.assert_array_equal(t[0].numpy(), iu)
        np.testing.assert_array_equal(t[1].numpy(), ju)
    rng = np.random.default_rng(1)
    z0 = rng.standard_normal((4, 8)).astype(np.float32)
    emb = rng.standard_normal((4, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tdlrm.interact(torch.from_numpy(z0), torch.from_numpy(emb)).numpy(),
        np.asarray(jdlrm.interact(jnp.asarray(z0), jnp.asarray(emb))), **TOL)


def test_forward_and_loss_match(pair):
    jarch, params, model = pair
    dense, idx, labels = _batch(jarch, 16, seed=2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    batch = {"dense": jnp.asarray(dense), "indices": jnp.asarray(idx),
             "labels": jnp.asarray(labels)}
    with torch.no_grad():
        logit = model(torch.from_numpy(dense), torch.from_numpy(idx))
        loss = model.loss_fn(torch.from_numpy(dense), torch.from_numpy(idx),
                             torch.from_numpy(labels))
    np.testing.assert_allclose(logit.numpy(),
                               np.asarray(jdlrm.forward(jp, batch, jarch)), **TOL)
    np.testing.assert_allclose(float(loss),
                               float(jdlrm.loss_fn(jp, batch, jarch)), **TOL)


def test_serve_query_matches(pair):
    jarch, params, model = pair
    rng = np.random.default_rng(3)
    user = np.stack([rng.integers(0, r, jarch.pooling)
                     for r in jarch.user_tables]).astype(np.int32)
    items = np.stack([rng.integers(0, r, (10, jarch.pooling))
                      for r in jarch.item_tables]).astype(np.int32)
    dense = rng.standard_normal((10, jarch.num_dense)).astype(np.float32)
    want = jdlrm.serve_query(jax.tree_util.tree_map(jnp.asarray, params),
                             jnp.asarray(user), jnp.asarray(items),
                             jnp.asarray(dense), jarch)
    with torch.no_grad():
        got = model.serve_query(*map(torch.from_numpy, (user, items, dense)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_serving_slice_matches_reference(pair, use_kernels):
    """Engine + scoring over three batches, as examples/serve_dlrm.py drives
    the reference: per-query ``sm_ios``/``latency_us`` exact, hit rate and
    cache state equal, pooled bags and scores within 1e-5."""
    jarch, params, model = pair
    n_user = len(jarch.user_tables)
    cfg = dict(hbm_cache_bytes=1 << 12, use_kernels=use_kernels)
    ref_engine = jeng.DeviceServingEngine(
        {i: params["tables"][i] for i in range(n_user)},
        jio.DEVICES["nand_flash"], jeng.EngineConfig(**cfg))
    engine = teng.DeviceServingEngine(
        {i: model.tables[i] for i in range(n_user)}, tio.DEVICES["nand_flash"],
        teng.EngineConfig(**cfg), torch_device="cpu")
    traffic = serve_dlrm.make_traffic(model.arch, queries=20, batch=8,
                                      item_batch=6, seed=4)
    got = serve_dlrm.serve(model, engine, traffic)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for tb, res in zip(traffic, got):
        pooled, stats = ref_engine.serve_batch(tb["user"], bg_iops=10_000.0)
        assert [s.sm_ios for s in res.stats] == [s.sm_ios for s in stats]
        assert [s.latency_us for s in res.stats] == [s.latency_us for s in stats]
        np.testing.assert_allclose(res.pooled, pooled, rtol=0, atol=1e-5)
        assert res.max_err <= 1e-5
        scores = jdlrm.serve_query(jp, jnp.asarray(tb["user"][0]),
                                   jnp.asarray(tb["items"]),
                                   jnp.asarray(tb["dense"]), jarch)
        np.testing.assert_allclose(res.scores, np.asarray(scores), **TOL)
    assert [len(r.stats) for r in got] == [8, 8, 4]
    assert engine.hit_rate == ref_engine.hit_rate
    for k, v in ref_engine.state.items():
        np.testing.assert_array_equal(engine.state[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_serve_dlrm_entry_point_on_cpu(capsys):
    serve_dlrm.main(["--device", "cpu", "--rows", "300", "--queries", "20",
                     "--batch", "8", "--item-batch", "4"])
    out = capsys.readouterr().out
    assert "served 20 queries" in out and "hit rate" in out


def test_same_seed_same_model_on_every_device():
    arch = tdlrm.DLRMArch(**FIELDS)
    a, _ = serve_dlrm.build(arch, seed=3, torch_device="cpu")
    b, _ = serve_dlrm.build(arch, seed=3, torch_device=torch.device("cpu"))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    arch = tdlrm.DLRMArch(**FIELDS)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdlrm.DLRM(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_dlrm.main(["--rows", "8", "--queries", "0"])


def test_port_imports_neither_jax_nor_reference():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'"
            " or m.startswith(('jax.', 'repro.')))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    for path in [ROOT / "chip_smoke.py", *(ROOT / "src" / "repro_torch").rglob("*.py")]:
        assert not pattern.search(path.read_text()), path
