"""The operations and bytes of kernels K3 and K4, the cross-scale
neighbourhood attention's forward and backward, counted from their shapes
whatever route runs them (``h100bench.work``'s conventions: each tensor
the kernel is handed read or written once, in its own dtype).

- K3, the forward: each query's k^2 logits (2 d each) and its weighted sum
  of k^2 values (2 dv each); q, keys and values read, the output written.
- K4, the backward: the logits recomputed (2 d), dP = dO V^T (2 dv),
  dV += P^T dO (2 dv), dQ = dS K (2 d) and dK += dS^T Q (2 d) at each of a
  query's k^2 cells; q, keys, values and dO read, dq, dk and dv written.
  Its box partials and their reduce pass are the route's, not the work's.
"""

from __future__ import annotations

from h100bench.work import attention_flops

__all__ = ["k3_work", "k4_work", "k34_work"]


def _sizes(b, q_hw, lr_hw, heads, d, dv):
    """Elements of q (and dq), keys (and dk), values (and dv), out (and dO)."""
    nq, nk = b * q_hw[0] * q_hw[1] * heads, b * lr_hw[0] * lr_hw[1] * heads
    return nq * d, nk * d, nk * dv, nq * dv


def k3_work(b: int, q_hw, lr_hw, heads: int, k: int, d: int, dv: int, elt: int = 2):
    """(FLOPs, bytes) of one K3 launch over queries ``q_hw`` and an LR grid
    ``lr_hw``, ``heads`` heads of widths d (queries, keys) and dv (values)."""
    flops = attention_flops(b, q_hw[0], q_hw[1], heads, k, d, dv)
    return flops, elt * sum(_sizes(b, q_hw, lr_hw, heads, d, dv))


def k4_work(b: int, q_hw, lr_hw, heads: int, k: int, d: int, dv: int, elt: int = 2):
    """(FLOPs, bytes) of K4 over the same shapes, all its bands together."""
    flops = b * q_hw[0] * q_hw[1] * heads * k * k * 2 * (3 * d + 2 * dv)
    nq, nk, nv, no = _sizes(b, q_hw, lr_hw, heads, d, dv)
    return flops, elt * (2 * (nq + nk + nv) + no)


def k34_work(b: int, q_hw, lr_hw, heads: int, k: int, d: int, dv: int, elt: int = 2):
    """(FLOPs, bytes) of one K3 and one K4 over the same shapes: the
    attention of a training step whose backward recomputes the forward."""
    f3, n3 = k3_work(b, q_hw, lr_hw, heads, k, d, dv, elt)
    f4, n4 = k4_work(b, q_hw, lr_hw, heads, k, d, dv, elt)
    return f3 + f4, n3 + n4
