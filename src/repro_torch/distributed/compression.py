"""Row-wise quantizer of the ESS quantized latent tier (the port's own copy
of the tier half of ``repro.distributed.compression``; the gradient
compression there is not on the serve path).

A quantized host tier stores each latent row as ``D`` one-byte values
(int8 or ``float8_e4m3fn``) plus one f16 scale, so a row pins ``D + 2``
bytes against ``2 D`` for bf16.  :func:`quantize_rows` and
:func:`dequantize_rows` share one grid: the scale used to dequantize is the
*stored* (f16-rounded) one, so an all-zero row round-trips to exact zeros.

These are plain tensor ops on either device, as in the reference (which
computes them in ``jnp`` outside any Pallas kernel).  Every step matches
the reference's compiled serve path bit for bit.  There XLA rewrites the
scale's ``amax / qmax`` as ``amax * (1 / qmax)`` (a division by a
constant), which can differ from the quotient in the last bit and so move
an f16 scale by one step where it lands on a rounding tie; the port
writes that product out.  The reciprocal is a Python float: PyTorch
rounds a scalar operand to the fp32 tensor's dtype, so the product is
the same fp32 ``amax * (1/qmax)`` on either device, with no
host-to-device copy in the step.
"""

from __future__ import annotations

import torch

#: per-row scale dtype: 2 bytes beside the row's D payload bytes
SCALE_DTYPE = torch.float16

#: ``ESSOptions.host_cache_dtype`` name -> payload dtype ("bf16" = none)
CACHE_QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def quant_max(dtype) -> float:
    """Largest representable magnitude of a quantized storage dtype."""
    return 127.0 if dtype == torch.int8 else 448.0        # e4m3fn max


def quantize_rows(x: torch.Tensor, dtype=torch.int8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization over the trailing axis.

    Returns ``(q [..., D] dtype, scale [..., 1] SCALE_DTYPE)``.  int8
    rounds half to even and clips to +-127; fp8 clips to +-448 before the
    cast.  All-zero rows get scale 0 and payload 0."""
    xf = x.float()
    m = quant_max(dtype)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax * (1.0 / m)).to(SCALE_DTYPE)
    s = scale.float()
    y = xf / torch.where(s > 0, s, torch.ones_like(s))
    if dtype == torch.int8:
        q = torch.round(y).clamp(-127, 127).to(torch.int8)
    else:
        q = y.clamp(-m, m).to(dtype)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: ``(float(q) * float(s))`` cast to
    ``out_dtype``; ``scale`` broadcasts over the trailing axis."""
    return (q.float() * scale.float()).to(out_dtype)


def wire_nbytes(*tensors) -> int:
    """Bytes a set of planes occupies (``None`` entries cost nothing): a
    quantized tier moves in its storage dtype, payload plus scale plane."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
