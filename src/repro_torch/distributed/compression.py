"""Gradient compression for the data-parallel all-reduce (int8 with error
feedback) and the row-wise quantizer of the ESS quantized latent tier
(the port's own copy of ``repro.distributed.compression``).

Gradients: :func:`compress_grads` quantizes each leaf per tensor to int8
after adding the residual of the round before, and keeps the new residual
(the quantization error), so the noise does not bias the sum over rounds
(error feedback).  The arithmetic is the reference's, op for op.
:func:`allreduce_compressed` is the data-parallel all-reduce itself: the
ranks' dequantized gradients averaged over a process group (the
reference's ``pmean`` inside ``shard_map``).

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

from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten

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


# ---------------------------------------------------------------------------
# Gradient compression (int8 + error feedback)
# ---------------------------------------------------------------------------

class EFState(NamedTuple):
    residual: Any     # the gradients' structure, fp32


def init_ef(params: Any) -> EFState:
    return EFState(tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params))


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``(q, scale)``, ``scale`` a 0-d fp32
    tensor (``max|x| / 127``)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Any, ef: EFState) -> tuple[Any, Any, EFState]:
    """``(q tree int8, scale tree, the new error-feedback state)``: each
    leaf plus its residual, quantized; the new residual is what the
    quantization lost."""
    q, s, r = [], [], []
    for g, res in zip(leaves(grads), leaves(ef.residual)):
        v = g.float() + res
        qi, si = quantize_int8(v)
        q.append(qi)
        s.append(si)
        r.append(v - dequantize_int8(qi, si))
    return unflatten(grads, q), unflatten(grads, s), \
        EFState(unflatten(grads, r))


def decompress_grads(q: Any, s: Any) -> Any:
    return tree_map(dequantize_int8, q, s)


def compression_error(grads: Any, ef: EFState) -> torch.Tensor:
    """Diagnostic: the relative L2 error of one quantize / dequantize
    round."""
    q, s, _ = compress_grads(grads, ef)
    deq = decompress_grads(q, s)
    num = sum(torch.sum((a.float() - b) ** 2)
              for a, b in zip(leaves(grads), leaves(deq)))
    den = sum(torch.sum(a.float() ** 2) for a in leaves(grads)) + 1e-12
    return torch.sqrt(num / den)


def allreduce_compressed(grads: Any, ef: EFState, group=None
                         ) -> tuple[Any, EFState]:
    """The compressed data-parallel gradient all-reduce: each rank
    quantizes its own gradients (:func:`compress_grads`, error feedback
    kept per rank), dequantizes them, and the ranks of ``group`` average
    the dequantized values (``all_reduce`` SUM, divided by the group's
    size).  Returns ``(the mean tree, this rank's new EFState)``."""
    import torch.distributed as dist
    q, s, ef2 = compress_grads(grads, ef)
    deq = decompress_grads(q, s)
    n = dist.get_world_size(group)

    def mean(x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x / n
    return tree_map(mean, deq), ef2
