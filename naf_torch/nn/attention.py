"""Cross-scale neighborhood attention layer, NHWC (counterpart of
``naf_tpu/nn/attention.py``).

Queries live on the output (H, W) grid, keys/values on the low-res (h, w)
feature grid; windows are k x k LR-cell neighbourhoods gathered straight
from the LR grid (``naf_torch.ops.na2d``).

Implementations (names kept from the JAX package):
- "pallas": ``kernels.na2d_fused.cross_scale_na2d_fused``, kernels K3 forward
  and K4 backward on CUDA tensors, their plain versions on CPU tensors;
- "xla": the plain gather + einsum oracle (any ratio, ``return_weights``);
- "auto": "pallas" for CUDA tensors, as the JAX package picks Pallas on the
  TPU, else "xla". ``return_weights`` always takes the oracle.

Banded execution (``row_cell0``/``full_hq``: q holds the query rows from LR
cell row ``row_cell0`` on of a ``full_hq``-row grid) runs on the "pallas"
implementation only; the "xla" one raises ``NotImplementedError``, as the
JAX package's does.
"""

from __future__ import annotations

from torch import nn

from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
from naf_torch.ops.na2d import cross_scale_na2d

__all__ = ["CrossScaleAttention"]


class CrossScaleAttention(nn.Module):
    """num_heads-way cross-scale NA; no learnable parameters."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int = 9,
                 impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown impl {impl!r}")
        self.dim = dim
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.impl = impl

    def forward(self, q, k, v, return_weights: bool = False, row_cell0: int = 0,
                full_hq=None):
        if self.dim % self.num_heads != 0:
            raise ValueError("dim must be divisible by num_heads")
        if v.shape[-1] % self.num_heads != 0:
            raise ValueError("value channels must be divisible by num_heads")
        b, hq, wq, _ = q.shape
        hk, wk = k.shape[1], k.shape[2]
        n = self.num_heads
        d = self.dim // n
        dv = v.shape[-1] // n
        qh = q.reshape(b, hq, wq, n, d)
        kh = k.reshape(b, hk, wk, n, d)
        vh = v.reshape(b, hk, wk, n, dv)
        impl = self.impl
        if impl == "auto":
            impl = "pallas" if q.device.type == "cuda" else "xla"
        if impl == "pallas" and not return_weights:
            out = cross_scale_na2d_fused(qh, kh, vh, self.kernel_size, scale=d ** -0.5,
                                         row_cell0=row_cell0, full_hq=full_hq)
            return out.reshape(b, hq, wq, n * dv)
        if row_cell0 != 0 or (full_hq is not None and full_hq != hq):
            raise NotImplementedError("banded attention requires the pallas impl")
        res = cross_scale_na2d(qh, kh, vh, self.kernel_size, scale=d ** -0.5,
                               return_weights=return_weights)
        if return_weights:
            out, weights = res
            return out.reshape(b, hq, wq, n * dv), weights
        return res.reshape(b, hq, wq, n * dv)
