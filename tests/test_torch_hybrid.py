"""Port vs reference: the hybrid family (the hybrid branch of
``repro_torch.models.transformer`` vs ``repro.models.transformer``) on the
reduced zamba2-1.2b (4 SSD layers, the shared attention + MLP block after
layers 2 and 4, 4 heads over 2 KV heads), the reference's weights loaded
through ``params_from_jax``, f32 caches, the same numpy inputs; and a
6-layer variant whose shared block is called once with 2 trailing layers,
as the full config has."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import lm_train, serve_lm
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT

import torch_lm_cases as C

ARCH = "zamba2-1.2b"
# loss and grads: measured loss gap 9.5e-7 and grads 1.3e-5 apart at most
# (7.1e-6 of the leaf's largest; the shared block's grads sum over its calls)
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
B, T = 2, 24


@pytest.fixture(scope="module", params=[{}, {"num_layers": 6, "shared_attn_every": 4}],
                ids=["reduced", "trailing"])
def case(request):
    return C.pair(ARCH, **request.param)


def test_units_interleave_the_shared_block(case):
    cfg = case["cfg"]
    kinds = "".join("A" if kind == "attn" else "s" for kind, _ in TT._units(case["model"]))
    every, L = cfg.shared_attn_every, cfg.num_layers
    assert kinds == ("s" * every + "A") * (L // every) + "s" * (L % every)
    assert all(blk is case["model"].shared for kind, blk in TT._units(case["model"])
               if kind == "attn")


def test_params_from_jax_checks_every_leaf(case):
    C.assert_every_leaf_loaded(case)
    assert set(case["params"]["shared"]) == {"ln1", "attn", "ln2", "mlp"}


def test_init_params_draw_one_shared_block():
    cfg = C.configs(ARCH)[1]
    p = TT.init_params(cfg, torch.Generator().manual_seed(5))
    assert tuple(p["shared"]["attn"]["wq"].shape) == (cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert tuple(p["blocks"]["ssd"]["x_proj"].shape) == (cfg.num_layers, cfg.d_model,
                                                         cfg.d_inner)
    assert bool((p["shared"]["ln1"] == 1).all())


def test_prefill_logits_match(case):
    toks = C.tokens(case["cfg"], B, T)
    got = TT.forward(case["model"], torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), C.ref_prefill(case, toks), **C.LOGIT_TOL)


def test_decode_steps_match(case):
    """24 decode steps against the reference's: logits at every step, every
    layer's SSD cache and each shared-block call's KV cache at the end."""
    toks = C.tokens(case["cfg"], B, T)
    want, jcache = C.ref_decode(case, toks, max_len=32)
    got, cache = C.port_decode(case, toks, max_len=32)
    np.testing.assert_allclose(got, want, **C.LOGIT_TOL)
    n_calls = case["cfg"].num_layers // case["cfg"].shared_attn_every
    assert cache.kv.k.shape[0] == n_calls and cache.ssd.state.shape[0] == case["cfg"].num_layers
    C.assert_kv_matches(cache.kv, jcache["kv"])
    C.assert_ssd_matches(cache.ssd, jcache["ssd"])
    assert cache.length == cache.kv.length == cache.ssd.length == T


def test_decode_matches_prefill(case):
    toks = torch.from_numpy(C.tokens(case["cfg"], B, T))
    cache = TT.init_cache(case["cfg"], B, 32, dtype=torch.float32, device="cpu")
    ops.reset_launch_counts()
    dec = serve_lm.decode(case["model"], cache, toks)
    assert ops.launch_counts()["flash_decode"] == 0            # CPU: plain version
    np.testing.assert_allclose(dec.numpy(), TT.forward(case["model"], toks).numpy(),
                               **C.LOGIT_TOL)


def test_loss_grads_and_one_step_match(case):
    C.assert_training_matches(case, C.ref_training(case), GRAD_TOL)


def test_out_of_order_position_raises():
    cfg = C.configs(ARCH)[1]
    model = TT.LM(cfg, device="cpu")
    cache = TT.init_cache(cfg, 2, 8, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="in order"):
        TT.decode_step(model, cache, tok, 1)
    TT.decode_step(model, cache, tok, 0)
    assert cache.length == 1
    assert jax.tree.leaves(cache.kv.valid[:, :, 0].tolist()) == [1] * (2 * 2)


def test_entry_points_on_cpu(capsys):
    serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "3",
                   "--tokens", "20", "--max-len", "24"])
    lm_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "2",
                   "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert "(hybrid)" in out[0] and "finite: True" in out[1]
    assert out[3] == "  flash_decode launches: 0"
    assert out[4].startswith("zamba2-1.2b-reduced: 4L d=64")
    assert [ln.split(" loss ")[0] for ln in out[5:]] == ["  step    0", "  step    2"]
    assert all(np.isfinite(float(ln.split(" loss ")[1])) for ln in out[5:])
