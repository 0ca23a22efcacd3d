"""Fused lm-head + softmax cross entropy on Hopper: the forward (K7) and
the backward's dx (K8) and dw (K9) behind one `torch.autograd.Function`.

The port of the JAX package's `ops/xent_pallas.py`.  The loss and its
gradients never put the [N, V] logits in device memory: the forward
walks the vocab with an online (max, sum-exp) carry and takes the target
logit on the way; the backward recomputes each logits tile from the
saved per-row logsumexp and contracts it at once into dx or dw.

- `xent_fwd`: per-row lse and target logit (CUDA source:
  `csrc/xent.cu`, K7).
- `xent_dx`: dx = sum_v (softmax - onehot) w (K8).
- `xent_dw`: dw = sum_n (softmax - onehot)^T x (K9).

Each wrapper launches its kernel for CUDA tensors, or raises; it takes
its plain PyTorch version (`*_reference`: the Pallas kernel's function
on whole tensors, in its order of casts) only for tensors on the CPU.
Each carries a plain integer `launches`, bumped once per kernel launch
and nowhere else.  `reference_cross_entropy` is the materialising
oracle.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


# ----------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ----------------------------------------------------------------------
def _scores(x, w):
    """f32 logits [N, V]: w cast to x's dtype, the product of values in
    x's dtype summed in f32 (a bf16 value is exact in f32)."""
    return torch.matmul(x.float(), w.to(x.dtype).float().T)


def _hits(targets, V: int):
    """Row indices and targets of the rows whose target is in [0, V):
    an out-of-range target matches no column (the Pallas kernels'
    `cols == tg`)."""
    t = targets.long()
    rows = ((t >= 0) & (t < V)).nonzero()[:, 0]
    return rows, t[rows]


def xent_fwd_reference(x, w, targets):
    """K7's function: lse [N, 1] f32 over all V logits, and the f32
    target logit [N, 1] (0 for an out-of-range target)."""
    s = _scores(x, w)
    rows, cols = _hits(targets, w.shape[0])
    tgt = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    tgt[rows] = s[rows, cols]
    return torch.logsumexp(s, dim=-1, keepdim=True), tgt[:, None]


def _dlogits(x, w, targets, lse):
    """dl = exp(s - lse) - onehot(target), in f32, cast to x's dtype (and
    held in f32 for the product), as the kernels cast it."""
    p = _scores(x, w).sub_(lse).exp_()
    rows, cols = _hits(targets, w.shape[0])
    p[rows, cols] -= 1.0
    return p.to(x.dtype).float()


def xent_dx_reference(x, w, targets, lse):
    """K8's function: dx [N, E] f32 = dl . w (w in x's dtype)."""
    return torch.matmul(_dlogits(x, w, targets, lse),
                        w.to(x.dtype).float())


def xent_dw_reference(x, w, targets, lse):
    """K9's function: dw [V, E] f32 = dl^T . x."""
    return torch.matmul(_dlogits(x, w, targets, lse).T, x.float())


def reference_cross_entropy(x, w, targets):
    """Materialising lse-form loss (the testing oracle): logits in x's
    dtype, logsumexp and the target gather in f32."""
    logits = (x @ w.to(x.dtype).T).float()
    lse = torch.logsumexp(logits, dim=-1)
    t = logits.gather(-1, targets.long()[:, None])[:, 0]
    return (lse - t).mean()


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    lib = _build.load("xent")
    if not getattr(lib, "_rt_typed", False):
        lib.rt_xent_fwd.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.rt_xent_dx.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.rt_xent_dw.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        for fn in (lib.rt_xent_fwd, lib.rt_xent_dx, lib.rt_xent_dw):
            fn.restype = _I
        lib._rt_typed = True
    return lib


def _check(x, w, targets, lse=None):
    """The kernels take contiguous, 16-byte aligned x [N, E] (f32 or
    bf16) and w [V, E] (f32 or x's dtype) with E % 8 == 0, targets [N]
    int32 / int64 and f32 lse [N, 1], all on x's CUDA device.  Returns
    (w in x's dtype, targets as int32)."""
    if x.device.type != "cuda":
        raise ValueError(
            f"the xent kernels run on CUDA tensors (got {x.device}); CPU "
            "tensors take the plain version"
        )
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (f32 or bf16)")
    if w.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"w's dtype {w.dtype} not supported (f32 or x's "
                         f"dtype {x.dtype})")
    if x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x must be [N, E] and w [V, E], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, E = x.shape
    if N < 1 or w.shape[0] < 1 or E % 8:
        raise ValueError(f"shape not supported: N, V >= 1 and E % 8 == 0 "
                         f"(got N {N}, V {w.shape[0]}, E {E})")
    if targets.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"targets must be int32 or int64, got "
                         f"{targets.dtype}")
    if tuple(targets.shape) != (N,):
        raise ValueError(f"targets must be [N] = [{N}], got "
                         f"{tuple(targets.shape)}")
    named = {"x": x, "w": w, "targets": targets}
    if lse is not None:
        if lse.dtype != torch.float32 or tuple(lse.shape) != (N, 1):
            raise ValueError("lse must be f32 [N, 1]")
        named["lse"] = lse
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return w.to(x.dtype), targets.to(torch.int32)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def xent_fwd(x, w, targets):
    """K7.  x [N, E], w [V, E], targets [N] -> (lse [N, 1] f32, target
    logit [N, 1] f32)."""
    if x.device.type == "cpu":
        return xent_fwd_reference(x, w, targets)
    wc, tg = _check(x, w, targets)
    N, E = x.shape
    lse = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    tgt = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    _raise_on(_lib().rt_xent_fwd(
        x.data_ptr(), wc.data_ptr(), tg.data_ptr(), lse.data_ptr(),
        tgt.data_ptr(), N, wc.shape[0], E, _KERNEL_DTYPES[x.dtype],
        _stream(x)), "xent_fwd")
    xent_fwd.launches += 1
    return lse, tgt


xent_fwd.launches = 0


def xent_dx(x, w, targets, lse):
    """K8.  -> dx [N, E] f32, unscaled."""
    if x.device.type == "cpu":
        return xent_dx_reference(x, w, targets, lse)
    wc, tg = _check(x, w, targets, lse)
    N, E = x.shape
    dx = torch.empty((N, E), dtype=torch.float32, device=x.device)
    _raise_on(_lib().rt_xent_dx(
        x.data_ptr(), wc.data_ptr(), tg.data_ptr(), lse.data_ptr(),
        dx.data_ptr(), N, wc.shape[0], E, _KERNEL_DTYPES[x.dtype],
        _stream(x)), "xent_dx")
    xent_dx.launches += 1
    return dx


xent_dx.launches = 0


def xent_dw(x, w, targets, lse):
    """K9.  -> dw [V, E] f32, unscaled."""
    if x.device.type == "cpu":
        return xent_dw_reference(x, w, targets, lse)
    wc, tg = _check(x, w, targets, lse)
    N, E = x.shape
    V = wc.shape[0]
    dw = torch.empty((V, E), dtype=torch.float32, device=x.device)
    _raise_on(_lib().rt_xent_dw(
        x.data_ptr(), wc.data_ptr(), tg.data_ptr(), lse.data_ptr(),
        dw.data_ptr(), N, V, E, _KERNEL_DTYPES[x.dtype], _stream(x)),
        "xent_dw")
    xent_dw.launches += 1
    return dw


xent_dw.launches = 0


# ----------------------------------------------------------------------
# the op
# ----------------------------------------------------------------------
class _PallasCrossEntropy(torch.autograd.Function):
    """Forward through K7, saving (x, w in x's dtype, targets, lse);
    backward through K8 and K9, scaled by g / N (the reference's `_fwd`
    and `_bwd`)."""

    @staticmethod
    def forward(ctx, x, w, targets):
        wc = w.to(x.dtype)  # cast once for all three kernels
        lse, tgt = xent_fwd(x, wc, targets)
        ctx.save_for_backward(x, wc, targets, lse)
        ctx.w_dtype = w.dtype
        return (lse - tgt).mean()

    @staticmethod
    def backward(ctx, g):
        x, wc, targets, lse = ctx.saved_tensors
        scale = g.float() / x.shape[0]
        dx = (xent_dx(x, wc, targets, lse) * scale).to(x.dtype)
        dw = (xent_dw(x, wc, targets, lse) * scale).to(ctx.w_dtype)
        return dx, dw, None


def pallas_cross_entropy(x, w, targets, block_n: int = 512,
                         block_v: int = 512):
    """Mean softmax cross entropy of rows of `x` against classes of `w`,
    never materialising the [N, V] logits.

    x: [N, E] (bf16 / f32), w: [V, E] (f32 master ok), targets: [N]
    int.  Returns the f32 scalar mean loss; gradients flow to x (in x's
    dtype) and w (in w's dtype).  `block_n` / `block_v` keep the
    reference's signature; the CUDA kernels use their own Hopper tiles
    whatever the blocks say (bf16 K7: 64 rows by 128 vocab columns a
    tile, two warpgroups taking the tiles in turn; bf16 K8 / K9: 64
    output rows by up to 768 columns, 32 rows of the other operand a
    step; f32 K7: 64 x 64 score tiles; f32 K8 / K9: 64 x 256 output
    slices)."""
    del block_n, block_v
    return _PallasCrossEntropy.apply(x, w, targets)
