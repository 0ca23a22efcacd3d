"""Flash attention on Hopper: the forward (K1) and the backward kernels
(K2 fused, K3 dQ, K4 dK/dV) behind one `torch.autograd.Function`.

The port of the JAX package's `ops/attention.py`.  q/k/v blocks stream
through an online softmax (f32 running max / sum / accumulator), so the
`[T, T]` score matrix never reaches device memory in the forward or the
backward; the backward recomputes P from the per-row logsumexp saved by
the forward (FlashAttention-2, Dao 2023).

- `flash_fwd`: O and LSE (CUDA source: `csrc/attention.cu`, K1).
- `flash_bwd_fused`: dQ, dK, dV with delta = rowsum(dO * O) in-kernel
  (K2), the route when `min(block_q, T) == min(block_k, T) == T`.
- `flash_bwd_dq` / `flash_bwd_dkv`: the split pair (K3, K4) for every
  other block shape, delta computed here.

`block_q` / `block_k` keep the reference's meaning for the route choice
and for `_supported`; the CUDA kernels use their own Hopper tiles
whatever the blocks say: in bf16 at heads to 128 (wgmma, TMA,
registers), K1 and K3 128-row q tiles, K2 and K4 128-row kv tiles over
64-row q tiles (64-row kv tiles at D 128); every kernel 32 rows in f32;
heads wider than 128 on the first design's kernels, their rows halved
until the shared-memory plan fits (to 16 in bf16 and 8 in f32), and
past 704 (bf16) or 1,024 (f32) columns cut into column slices, one a
CTA, so every width the reference takes runs on the card.  A shape
`_supported` refuses (T not divisible by a block, or D % 8) goes to
`plain_attention`, as the reference documents;
`flash_attention.plain_dispatches` counts those calls.

Each wrapper works on folded `[BH, T, D]` tensors and launches its kernel
for CUDA tensors, or raises; it takes its plain PyTorch version
(`*_reference`: the Pallas kernel's function on whole tensors, in its
order of casts) only for tensors on the CPU.  Each wrapper carries a
plain integer `launches`, bumped once per kernel launch and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.parallel.ring_attention import plain_attention

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _supported(T: int, D: int, block_q: int, block_k: int) -> bool:
    """The blocks come in clamped to T, so only divisibility and the
    head width can refuse a shape."""
    return T % block_q == 0 and T % block_k == 0 and D % 8 == 0


def _fold(x):
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()


def _unfold(x, B, H):
    BH, T, D = x.shape
    return x.reshape(B, H, T, D).permute(0, 2, 1, 3)


# ----------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ----------------------------------------------------------------------
def _scores(q, k, causal: bool, scale: float):
    """f32 S = q k^T * scale with the -1e30 causal mask, [BH, T, T]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        T = s.shape[-1]
        keep = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    return s


def flash_fwd_reference(q, k, v, causal: bool, scale: float):
    """K1's function on whole tensors: the Pallas kernel with one kv
    block.  m starts at -1e30, P is cast to the input dtype before P.V,
    l == 0 is guarded.  Returns O [BH, T, D] (input dtype) and LSE
    [BH, T, 1] f32."""
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1).clamp_min(_NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = (acc / safe_l[..., None]).to(q.dtype)
    return out, (m + torch.log(safe_l))[..., None]


def _probs(q, k, lse, causal, scale):
    return torch.exp(_scores(q, k, causal, scale) - lse)


def flash_bwd_fused_reference(q, k, v, dout, lse, out, causal: bool,
                              scale: float):
    """K2's function: delta from dO and O in f32; P from the saved LSE;
    dS cast to the input dtype before both of its products."""
    dt = q.dtype
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    p = _probs(q, k, lse, causal, scale)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dout.float())
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                           scale: float):
    """K3's function: dQ = (P (dP - delta) * scale cast to the input
    dtype) K, accumulated in f32."""
    dt = q.dtype
    p = _probs(q, k, lse, causal, scale)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * scale
    return torch.matmul(ds.to(dt).float(), k.float()).to(dt)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal: bool,
                            scale: float):
    """K4's function: dV = P^T dO with P in the input dtype, dK = dS^T Q
    with dS in the input dtype, both accumulated in f32."""
    dt = q.dtype
    p = _probs(q, k, lse, causal, scale)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dout.float())
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dk = torch.matmul(ds.to(dt).float().transpose(-1, -2), q.float())
    return dk.to(dt), dv.to(dt)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    if not getattr(lib, "_rt_typed", False):
        lib.rt_flash_fwd.argtypes = [_P] * 5 + [_I] * 3 + [_F, _I, _I, _P]
        lib.rt_flash_bwd_fused.argtypes = (
            [_P] * 9 + [_I] * 3 + [_F, _I, _I, _P])
        lib.rt_flash_bwd_dq.argtypes = [_P] * 7 + [_I] * 3 + [_F, _I, _I, _P]
        lib.rt_flash_bwd_dkv.argtypes = [_P] * 8 + [_I] * 3 + [_F, _I, _I, _P]
        for fn in (lib.rt_flash_fwd, lib.rt_flash_bwd_fused,
                   lib.rt_flash_bwd_dq, lib.rt_flash_bwd_dkv):
            fn.restype = _I
        lib._rt_typed = True
    return lib


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def _check(q, **others):
    """The kernels take contiguous [BH, T, D] q/k/v/dO/O of one dtype
    (f32 or bf16) with D % 8 == 0, and f32 [BH, T, 1] LSE / delta, all
    on q's CUDA device."""
    if not _on_card(q):
        raise ValueError(
            f"the flash kernels run on CUDA tensors (got {q.device}); CPU "
            "tensors take the plain version"
        )
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (f32 or bf16)")
    if q.dim() != 3:
        raise ValueError(f"q must be folded [BH, T, D], got {tuple(q.shape)}")
    BH, T, D = q.shape
    if D % 8:
        raise ValueError(f"head width {D} not supported: D % 8 == 0")
    for name, t in {"q": q, **others}.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("lse", "delta"):
            if t.dtype != torch.float32 or tuple(t.shape) != (BH, T, 1):
                raise ValueError(f"{name} must be f32 [BH, T, 1]")
        elif t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q's dtype and shape")
    return BH, T, D


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, causal: bool, scale: float):
    """K1.  q/k/v [BH, T, D] -> (O [BH, T, D] in q's dtype, LSE
    [BH, T, 1] f32)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale)
    BH, T, D = _check(q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((BH, T, 1), dtype=torch.float32, device=q.device)
    _raise_on(_lib().rt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), BH, T, D, float(scale), int(causal),
        _KERNEL_DTYPES[q.dtype], _stream(q)), "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_fused(q, k, v, dout, lse, out, causal: bool, scale: float):
    """K2.  -> (dQ, dK, dV) in q's dtype.  dQ is summed over kv tiles
    into a zeroed f32 scratch (by TMA reduce-adds in bf16, by atomics in
    f32), so its rounding varies from run to run; dK and dV are
    deterministic."""
    if q.device.type == "cpu":
        return flash_bwd_fused_reference(q, k, v, dout, lse, out, causal,
                                         scale)
    BH, T, D = _check(q, k=k, v=v, dout=dout, lse=lse, out=out)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _raise_on(_lib().rt_flash_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), out.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), BH, T, D, float(scale), int(causal),
        _KERNEL_DTYPES[q.dtype], _stream(q)), "flash_bwd_fused")
    flash_bwd_fused.launches += 1
    return dq_acc.to(q.dtype), dk, dv


flash_bwd_fused.launches = 0


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K3.  -> dQ in q's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal,
                                      scale)
    BH, T, D = _check(q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    _raise_on(_lib().rt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, T, D,
        float(scale), int(causal), _KERNEL_DTYPES[q.dtype], _stream(q)),
        "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K4.  -> (dK, dV) in q's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal,
                                       scale)
    BH, T, D = _check(q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _raise_on(_lib().rt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
        T, D, float(scale), int(causal), _KERNEL_DTYPES[q.dtype],
        _stream(q)), "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


# ----------------------------------------------------------------------
# the op
# ----------------------------------------------------------------------
class _FlashAttention(torch.autograd.Function):
    """Forward through K1, saving (q, k, v, LSE, O) folded; backward
    through K2 when both blocks cover T, else K3 + K4 (the reference's
    `_bwd` route choice)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        B, T, H, D = q.shape
        scale = 1.0 / (D ** 0.5)
        qf, kf, vf = _fold(q), _fold(k), _fold(v)
        out, lse = flash_fwd(qf, kf, vf, causal, scale)
        ctx.save_for_backward(qf, kf, vf, lse, out)
        ctx.args = (causal, block_q, block_k, scale, B, H)
        return _unfold(out, B, H)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, lse, out = ctx.saved_tensors
        causal, block_q, block_k, scale, B, H = ctx.args
        T = qf.shape[1]
        dof = _fold(g.to(qf.dtype))
        if block_q == T and block_k == T:
            dq, dk, dv = flash_bwd_fused(qf, kf, vf, dof, lse, out, causal,
                                         scale)
        else:
            delta = (dof.float() * out.float()).sum(dim=-1, keepdim=True)
            dq = flash_bwd_dq(qf, kf, vf, dof, lse, delta, causal, scale)
            dk, dv = flash_bwd_dkv(qf, kf, vf, dof, lse, delta, causal,
                                   scale)
        return (_unfold(dq, B, H), _unfold(dk, B, H), _unfold(dv, B, H),
                None, None, None)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 1024,
                    block_k: int = 1024):
    """q/k/v [B, T, H, D] -> [B, T, H, D], differentiable.  Shapes that
    `_supported` refuses run `plain_attention` (counted in
    `flash_attention.plain_dispatches`)."""
    B, T, H, D = q.shape
    block_q, block_k = min(block_q, T), min(block_k, T)
    if not _supported(T, D, block_q, block_k):
        flash_attention.plain_dispatches += 1
        return plain_attention(q, k, v, causal=causal)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


flash_attention.plain_dispatches = 0
