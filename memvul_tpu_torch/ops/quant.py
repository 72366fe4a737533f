"""Dynamic int8 matmul for inference (the JAX package's ``ops/quant.py``).

Scheme: symmetric, zero-point-free scales, one per activation row (taken
on the fly) and one per weight output column; an int8 × int8 → int32
product; the int32 sums dequantized in f32 as ``(acc · x_scale) ·
w_scale``, then cast to the compute dtype, and the bias added in that
dtype.  The same f32 weights serve the full-precision and the quantized
forward: quantization is a property of the forward, not of the weights.

The reference contracts with an XLA ``dot_general`` outside any Pallas
kernel, so the port's contraction is a library int8 GEMM,
``torch._int_mm`` (cuBLASLt on the card, an exact integer product on the
CPU).  On the card it wants more than 16 rows, K and N multiples of 8,
and, as every cuBLASLt int8 layout takes it, a row-major left operand and
a column-major right one.  :func:`_int_mm` pads rows and the K and N
edges with zeros, which changes no sum, and slices the result back.
:data:`calls` counts its products.

Rounding follows the reference element for element: the quotient
``x / scale`` (never a product with the reciprocal), round half to even,
a clamp at ±127, a scale floor of ``eps = 1e-8`` (an all-zero row gives
exact zeros), and the dequantize in the order above.

:class:`QuantLinear` is the ``nn.Linear`` the encoder's six projections
per layer become under ``BertConfig.quant``: ``"int8_dynamic"``
re-quantizes the weight at every call; ``"int8"`` quantizes it once, at
first use, into non-persistent buffers (derived state, never in the
``state_dict``), which gives the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

INT8_MAX = 127.0
QUANT_MODES = ("int8_dynamic", "int8")

# int8 GEMMs since the last reset (a caller sets it back to 0)
calls = 0


def quantize_rowwise(x: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """float [..., K] → (int8 [..., K], f32 scales [..., 1]): each last-axis
    row scaled by max|row| / 127."""
    x32 = x.to(torch.float32)
    scales = x32.abs().amax(dim=-1, keepdim=True).clamp_min(eps) / INT8_MAX
    q = torch.clamp(torch.round(x32 / scales), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q.contiguous(), scales


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b_t[N, K].T`` → int32 [M, N], exactly.  Pads M past 16
    and K, N to multiples of 8 with zeros for the card's int8 GEMM."""
    global calls
    m, k = a.shape
    n = b_t.shape[0]
    mp = m if m > 16 else 32
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    acc = torch._int_mm(
        _pad_to(a, mp, kp).contiguous(), _pad_to(b_t, np_, kp).contiguous().t()
    )
    calls += 1
    return acc[:m, :n]


def _dequantize(acc: torch.Tensor, x_scales: torch.Tensor, w_scales: torch.Tensor, out_dtype):
    """``((acc · x_scales) · w_scales)`` in f32, then ``out_dtype``; the
    products run in place on the f32 copy (same rounding, one buffer)."""
    y = acc.to(torch.float32)
    del acc
    y.mul_(x_scales)
    y.mul_(w_scales)
    return y.to(out_dtype)


def _contract(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor, out_dtype) -> torch.Tensor:
    """``x [..., K]`` against int8 ``w_q [N, K]`` with scales ``w_s [N]``."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_rowwise(x.reshape(-1, k))
    y = _dequantize(_int_mm(xq, w_q), xs, w_s, out_dtype)
    return y.reshape(*lead, w_q.shape[0])


def int8_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` via dynamic int8: x quantized per row, w
    per output column, an int32 product, then the dequantize."""
    w_q, w_s = quantize_rowwise(w.to(torch.float32).t())  # [N, K], [N, 1]
    return _contract(x, w_q, w_s[:, 0], out_dtype)


def quantize_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float [K, N] → (int8 [K, N], f32 scales [N]): :func:`quantize_rowwise`
    of ``w.T`` transposed back, so :func:`int8_matmul_prequant` of the
    result gives :func:`int8_matmul`'s bits."""
    w_q, w_s = quantize_rowwise(w.to(torch.float32).t())
    return w_q.t(), w_s[:, 0]


def int8_matmul_prequant(
    x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """``x [..., K] @ dequant(w_q [K, N], w_s [N])`` with the weight already
    quantized (:func:`quantize_colwise`); x is quantized per row here."""
    return _contract(x, w_q.t().contiguous(), w_s, out_dtype)


class QuantLinear(nn.Linear):
    """``nn.Linear`` (same parameters, same ``state_dict``) whose forward
    contracts in int8: ``mode`` ``"int8_dynamic"`` quantizes the weight at
    every call, ``"int8"`` once, into the non-persistent buffers
    ``weight_q`` [out, in] and ``weight_scale`` [out] (inference only: the
    weights must not change after the first call).  ``bias=False`` makes
    it bias-free, as ``nn.Linear``'s own flag does."""

    def __init__(self, in_features: int, out_features: int, mode: str, bias: bool = True,
                 device=None, dtype=None) -> None:
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {mode!r}")
        self.mode = mode
        self.register_buffer("weight_q", None, persistent=False)
        self.register_buffer("weight_scale", None, persistent=False)

    @torch.no_grad()
    def quantized_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int8 [out, in], f32 scales [out]) of the current weight."""
        if self.mode == "int8" and self.weight_q is not None:
            return self.weight_q, self.weight_scale
        w_q, w_s = quantize_rowwise(self.weight)
        if self.mode == "int8":
            self.weight_q, self.weight_scale = w_q, w_s[:, 0]
            return self.weight_q, self.weight_scale
        return w_q, w_s[:, 0]

    def quantized(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """The int8 projection of ``x`` in ``dtype``, bias added in ``dtype``."""
        w_q, w_s = self.quantized_weight()
        out = _contract(x.to(dtype), w_q, w_s, dtype)
        return out if self.bias is None else out + self.bias.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.quantized(x, x.dtype)


def make_linear(in_features: int, out_features: int, quant: Optional[str], bias: bool = True,
                dtype=None) -> nn.Linear:
    """``nn.Linear``, or its int8 twin when ``quant`` names a mode (params
    in ``dtype``, f32 by default)."""
    if quant is None:
        return nn.Linear(in_features, out_features, bias=bias, dtype=dtype)
    return QuantLinear(in_features, out_features, quant, bias=bias, dtype=dtype)
