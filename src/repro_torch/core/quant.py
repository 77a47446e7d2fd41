"""Row-wise embedding quantization (paper footnote 4, App. A.5).

Rows are stored as ``[scale f32 | bias f32 | payload int8/int4]``. Row bytes
are 8 + D (int8) or 8 + ceil(D/2) (int4). Rounding is half to even, as in
the JAX reference, so payload, scale and bias are bit-equal to it.
"""
from __future__ import annotations

import torch

HEADER_BYTES = 8  # fp32 scale + fp32 bias per row


def row_bytes(dim: int, bits: int = 8) -> int:
    payload = dim if bits == 8 else (dim + 1) // 2
    return HEADER_BYTES + payload


def quantize_rows(table: torch.Tensor, bits: int = 8) -> dict:
    """table: [R, D] float. Returns dict(payload, scale, bias, bits, dim).

    Asymmetric row-wise: q = round((x - min) / scale), scale = (max-min)/levels.
    """
    levels = (1 << bits) - 1
    x = table.to(torch.float32)
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    # divide by a tensor: CUDA turns division by a host scalar into a
    # multiply by its reciprocal, which rounds differently from the reference
    scale = torch.where(hi > lo, (hi - lo) / torch.full_like(hi, levels),
                        torch.ones_like(hi))
    q = torch.clamp(torch.round((x - lo) / scale), 0, levels)
    if bits == 8:
        payload = q.to(torch.uint8)
    elif bits == 4:
        q = q.to(torch.uint8)
        if q.shape[1] % 2:
            q = torch.cat([q, q.new_zeros((q.shape[0], 1))], dim=1)
        payload = q[:, 0::2] | (q[:, 1::2] << 4)
    else:
        raise ValueError(f"bits={bits}")
    return {"payload": payload, "scale": scale[:, 0], "bias": lo[:, 0],
            "bits": bits, "dim": table.shape[1]}


def dequantize_rows(qt: dict, idx=None) -> torch.Tensor:
    """Dequantize all rows (idx=None) or a gather of rows."""
    payload, scale, bias = qt["payload"], qt["scale"], qt["bias"]
    if idx is not None:
        idx = torch.as_tensor(idx, device=payload.device).long()
        payload, scale, bias = payload[idx], scale[idx], bias[idx]
    if qt["bits"] == 4:
        q = torch.stack([payload & 0xF, payload >> 4], dim=-1)
        q = q.reshape(payload.shape[0], -1)[:, : qt["dim"]]
    else:
        q = payload
    return q.to(torch.float32) * scale[:, None] + bias[:, None]
