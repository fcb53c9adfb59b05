"""``reference/naf.py``'s NAF forward computed in blocks of output rows, for
outputs whose float32 whole would not fit beside the program's (4096^2 x
384 is 24 GiB in float32, and the pooled encoder output and queries 16 GiB
each). The same statement of the model, with the same functions where they
apply; only the order of work differs:

  x                  the encoder output, whole (it is at the guide's size)
  q[r0:r1]           the pooled rows [r0, r1) of x, RoPE'd with the angles
                     of those global rows
  keys = sum over blocks of the pool of q[r0:r1] to the feature grid
                     (the pool is linear in the rows: a first sweep)
  out[r0:r1]         each query row's window over keys and the features, by
                     its global row's window (a second sweep)

``q8`` rounds as ``reference/naf.py`` rounds, but a block at a time: the
float8 control's per-tensor scale of q and of the output is taken per block
of rows (a finer scale, so the control reads no higher than a whole-tensor
one would).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import naf as ref_naf

__all__ = ["naf_rows"]


def _id(t):
    return t


def _pool(x, ph: np.ndarray, pw: np.ndarray):
    """Pool the (H, W) axes of an NHWC tensor by (rows, H) and (cols, W)
    matrices."""
    return torch.einsum("oh,bhwc,pw->bopc", torch.from_numpy(ph).to(x.device), x,
                        torch.from_numpy(pw).to(x.device))


def _rope_rows(x, heads: int, base: float, row0: int, full_h: int):
    """``ref_naf.rope`` of rows [row0, row0 + rows) of a ``full_h``-row map."""
    b, h, w, c = x.shape
    d = c // heads
    au = ref_naf.rope_angles(full_h, d, base)[row0:row0 + h].to(x.device)[:, None, None, :]
    av = ref_naf.rope_angles(w, d, base).to(x.device)[None, :, None, :]
    q0, q1, q2, q3 = x.reshape(b, h, w, heads, 4, d // 4).unbind(-2)
    out = (q0 * au.cos() - q2 * au.sin(), q1 * av.cos() - q3 * av.sin(),
           q2 * au.cos() + q0 * au.sin(), q3 * av.cos() + q1 * av.sin())
    return torch.stack(out, dim=-2).reshape(b, h, w, c)


def _attention_rows(q, keys, v, rows: np.ndarray, heads: int, k: int, q8=_id):
    """``ref_naf.cross_scale_attention`` for a block of query rows whose
    windows' LR rows are ``rows`` (block rows, k)."""
    b, hq, wq, c = q.shape
    hk, wk = keys.shape[1], keys.shape[2]
    d, dv = c // heads, v.shape[-1] // heads
    cols = torch.from_numpy(ref_naf.cross_scale_indices(wq, wk, k)).to(q.device)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    qh = q.reshape(b, hq, wq, heads, d) * d ** -0.5
    kh = keys.reshape(b, hk, wk, heads, d)
    vh = v.reshape(b, hk, wk, heads, dv)
    out = q.new_empty(b, hq, wq, heads, dv)
    for u, pattern in enumerate(uniq):
        sel = torch.from_numpy(np.nonzero(inv == u)[0]).to(q.device)
        rsel = torch.from_numpy(pattern).to(q.device)
        kg = kh[:, rsel][:, :, cols]
        vg = vh[:, rsel][:, :, cols]
        logits = torch.einsum("brwnd,btwsnd->brwnts", qh[:, sel], kg)
        prob = q8(torch.softmax(logits.flatten(-2), dim=-1)).reshape(logits.shape)
        out[:, sel] = torch.einsum("brwnts,btwsnd->brwnd", prob, vg)
    return out.reshape(b, hq, wq, heads * dv)


@torch.no_grad()
def naf_rows(p: dict, model: dict, image, feats, out_hw, block_rows: int, q8=_id):
    """Yield (r0, out[:, r0:r0 + block_rows]) of ``ref_naf.naf_forward``
    (float32 NHWC) for ``p`` the f32 weights (``ref_naf.naf_params``),
    ``image`` and ``feats`` NHWC."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    p = {k: q8(v) for k, v in p.items()}
    image, feats = q8(image), q8(feats)
    h, w = image.shape[1], image.shape[2]
    if h > 4 * oh or w > 4 * ow:
        gh, gw = min(h, 4 * oh, 4 * ow), min(w, 4 * ow, 4 * oh)
        image = F.interpolate(image.permute(0, 3, 1, 2), size=(gh, gw), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
    layers = model["img_layers"]
    x = torch.cat([ref_naf.encoder(image, p, "image_encoder.encoder", layers, q8=q8),
                   ref_naf.encoder(image, p, "image_encoder.sem_encoder", layers, q8=q8)], dim=-1)
    hk, wk = feats.shape[1], feats.shape[2]
    ph, pw = ref_naf.pool_matrix(x.shape[1], oh), ref_naf.pool_matrix(x.shape[2], ow)
    kh, kw = ref_naf.pool_matrix(oh, hk), ref_naf.pool_matrix(ow, wk)
    starts = range(0, oh, block_rows)

    def q_rows(r0):
        r1 = min(r0 + block_rows, oh)
        return q8(_rope_rows(_pool(x, ph[r0:r1], pw), model["heads_rope"], model["rope_base"],
                             r0, oh))

    keys = sum(_pool(q_rows(r0), np.ascontiguousarray(kh[:, r0:r0 + block_rows]), kw)
               for r0 in starts)
    keys = q8(keys)
    rows = ref_naf.cross_scale_indices(oh, hk, model["kernel_size"])
    for r0 in starts:
        out = _attention_rows(q_rows(r0), keys, feats, rows[r0:r0 + block_rows],
                              model["heads_attn"], model["kernel_size"], q8=q8)
        yield r0, q8(out)
