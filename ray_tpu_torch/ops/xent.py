"""Fused chunked softmax cross entropy against a tied embedding matrix.

The port of the JAX package's `ops/xent.py`.  The op walks the [N, E]
hidden states in row chunks (a Python loop in place of `lax.scan`):

- forward: per chunk, logits = x_c w^T (products of values in x's
  dtype, f32 sums), reduced at once to the per-row logsumexp and target
  logit; only the per-row lse (N floats) is kept for the backward.
- backward: recompute the chunk's logits, form dl = softmax -
  onehot(targets) scaled by g / N and cast to x's dtype, and contract it
  at once into dx_c and a running f32 dw.

At most one f32 [chunk, V] block is alive at a time.  There is no
Pallas kernel behind it in the reference (XLA lowers the scan), so the
products here are `torch.matmul`; `ops/xent_pallas.py` is the kernel
route.
"""

from __future__ import annotations

import torch


def _pick_chunk(n_rows: int, requested: int) -> int:
    """The largest chunk <= `requested` that divides `n_rows`."""
    c = min(requested, n_rows)
    while n_rows % c:
        c -= 1
    return c


def _chunk_logits(x_c, wc):
    """f32 logits of one chunk: w already in x's dtype, values exact in
    f32, so the f32 product is the product in x's dtype with f32 sums."""
    return torch.matmul(x_c.float(), wc.float().T)


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        N = x.shape[0]
        C = _pick_chunk(N, chunk)
        wc = w.to(x.dtype)
        t = targets.long()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for i in range(0, N, C):
            logits = _chunk_logits(x[i:i + C], wc)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, t[i:i + C, None])[:, 0]
            total = total + (lse - tgt).sum()
            lses.append(lse)
        ctx.save_for_backward(x, wc, t, torch.cat(lses))
        ctx.chunk, ctx.w_dtype = C, w.dtype
        return total / N

    @staticmethod
    def backward(ctx, g):
        x, wc, t, lse = ctx.saved_tensors
        N, C = x.shape[0], ctx.chunk
        scale = g.float() / N
        dx = torch.empty_like(x)
        dw = torch.zeros(wc.shape, dtype=torch.float32, device=x.device)
        rows = torch.arange(C, device=x.device)
        for i in range(0, N, C):
            x_c = x[i:i + C]
            p = _chunk_logits(x_c, wc).sub_(lse[i:i + C, None]).exp_()
            p[rows, t[i:i + C]] -= 1.0
            dl = (p * scale).to(x.dtype).float()
            dx[i:i + C] = torch.matmul(dl, wc.float()).to(x.dtype)
            dw += torch.matmul(dl.T, x_c.float())
        return dx, dw.to(ctx.w_dtype), None, None


def fused_cross_entropy(x, w, targets, chunk: int = 2048):
    """Mean softmax cross entropy of rows of `x` against classes of `w`.

    x: [N, E] activations (any float dtype; products in x's dtype), w:
    [V, E] class embedding matrix (f32 master ok; cast inside),
    targets: [N] int.  Returns the f32 scalar mean loss."""
    return _FusedCrossEntropy.apply(x, w, targets, chunk)
