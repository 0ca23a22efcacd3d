"""Card tests of the compiled graphs' channel and of Mixtral's training
step (torch only: they run where the card is, without JAX).  Marked
`cuda`; each skips here, where there is no card.

- CUDA tensors (bf16, f32, int8; inline in the slot and spilled past
  it) cross a channel bit-equal, in their dtype, onto the reader's card;
- a 1-layer Mixtral step on the flash kernels against the same step on
  dense attention, at the bf16 limits of `chip_smoke.py`'s Mixtral line
  (loss 2e-2 relative; the `wq` and `moe_w_in` gradients 3e-2 by the
  relative norm of the difference, the experts held to the dense
  pass's), with one K1 for the forward, one for the remat replay and
  one K2 a flash pass.
"""

import dataclasses

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.dag import channel
from ray_tpu_torch.models import mixtral
from ray_tpu_torch.ops import attention as fa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's card path has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def cluster(card):
    rt.init(num_workers=1, num_cpus=2)
    yield card
    rt.shutdown()


@pytest.mark.cuda
def test_cuda_tensors_cross_a_channel_bit_equal(cluster):
    dev = cluster
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    payloads = [
        torch.randn((4, 1024), generator=gen, device=dev).bfloat16(),
        torch.randn((2, 1024, 1024), generator=gen, device=dev).bfloat16(),
        {"f32": torch.randn((64, 33), generator=gen, device=dev),
         "i8": torch.randint(-128, 128, (3, 5), generator=gen, device=dev,
                             dtype=torch.int8)},
    ]
    ch = channel.Channel("card_roundtrip")
    try:
        for value in payloads:
            ch.write(value)
            got = ch.read(timeout_s=60)
            pairs = ([(got[k], v) for k, v in value.items()]
                     if isinstance(value, dict) else [(got, value)])
            for a, b in pairs:
                assert a.is_cuda and a.device == dev and a.dtype == b.dtype
                assert torch.equal(a, b)
    finally:
        ch.destroy()


@pytest.mark.cuda
def test_mixtral_flash_step_matches_dense_step(card):
    """The flash route against the dense route at step 0, held by
    `chip_smoke.mixtral_route_check`: the loss at 2e-2 relative, and the
    `wq` / `moe_w_in` gradients at relative norm 3e-2 with the flash
    pass routed to the dense pass's experts (a few tokens choose other
    experts on their own: discrete top-k amplifies the routes' last-bit
    differences)."""
    from chip_smoke import mixtral_route_check

    cfg = dataclasses.replace(
        mixtral.MixtralConfig.tiny(vocab_size=1000), dim=1024, n_layers=1,
        n_heads=8, n_kv_heads=2, intermediate=2048, num_experts=8,
        attention="flash")
    params = mixtral.init_params(cfg, 0, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen,
                           device=card)
    for name in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        getattr(fa, name).launches = 0
    fa.flash_attention.plain_dispatches = 0
    got = mixtral_route_check(cfg, params, tokens)
    # two flash passes (free, then held): each one K1 forward, one K1
    # remat replay, one K2
    assert (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
            fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
            fa.flash_attention.plain_dispatches) == (4, 2, 0, 0, 0)
    assert got["loss_rel_err"] <= 2e-2
    assert max(got["grad_rel_err"].values()) <= 3e-2
