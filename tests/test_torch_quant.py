"""Port vs reference: row-wise quantization (``repro_torch.core.quant`` vs
``repro.core.quant``). Same numpy inputs; payload, scale and bias bit-equal
(both round half to even), dequantized rows equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _table(R, D, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, D)).astype(np.float32)
    x[0] = 0.25                          # constant row: hi == lo
    x[1] = -3.0
    if R > 3:
        x[2] = np.round(x[2] * 8) / 8    # many exact ties at .5 steps
    return x


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R,D", [(16, 8), (33, 7), (5, 1), (64, 96)])
def test_quantize_bit_equal(bits, R, D):
    x = _table(R, D, seed=R * D + bits)
    ref = jq.quantize_rows(jnp.asarray(x), bits=bits)
    got = tq.quantize_rows(torch.from_numpy(x), bits=bits)
    for k in ("payload", "scale", "bias"):
        _bits_equal(got[k].numpy(), ref[k])
    assert (got["bits"], got["dim"]) == (ref["bits"], ref["dim"])


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_equal(bits):
    x = _table(40, 13, seed=bits)
    ref = jq.quantize_rows(jnp.asarray(x), bits=bits)
    got = tq.quantize_rows(torch.from_numpy(x), bits=bits)
    _bits_equal(tq.dequantize_rows(got).numpy(), jq.dequantize_rows(ref))
    idx = np.array([3, 0, 39, 3], np.int32)
    _bits_equal(tq.dequantize_rows(got, idx).numpy(),
                jq.dequantize_rows(ref, jnp.asarray(idx)))


def test_float64_input_rounds_like_reference():
    x = np.random.default_rng(3).standard_normal((9, 6))       # float64
    ref = jq.quantize_rows(jnp.asarray(x))
    got = tq.quantize_rows(torch.from_numpy(x))
    for k in ("payload", "scale", "bias"):
        _bits_equal(got[k].numpy(), ref[k])


def test_row_bytes_and_bad_bits():
    for d in (1, 7, 8, 64, 96):
        for bits in (8, 4):
            assert tq.row_bytes(d, bits) == jq.row_bytes(d, bits)
    assert tq.HEADER_BYTES == jq.HEADER_BYTES
    with pytest.raises(ValueError):
        tq.quantize_rows(torch.zeros(2, 2), bits=3)
