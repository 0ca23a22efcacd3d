"""Card test of the port's perf harness (torch only: it runs where the
card is, without JAX).  Marked `cuda`; it skips here, where there is no
card.  Run from the repo root: it imports `chip_smoke`.

`--config decode_kernel --decode-batches 4` and `--engine-trace
--engine-requests 8` through `perf.main` on the card, with the reference
test's gates (`tests/test_perf_harness.py`, `kernel` for `pallas`) and
the decode rows' fused append + attention launches: L x chunk for each
kernel-route dispatch and for the warm-up chunk each kernel-route engine
runs when it is built, no K5 or K6 of their own.
"""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel route launches the "
                    "fused paged-attention kernel")
    from ray_tpu_torch.ops import _build

    _build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_decode_kernel_rows_on_the_card(card):
    import chip_smoke

    run = chip_smoke.perf_run(["--config", "decode_kernel",
                               "--decode-batches", "4", "--device", "cuda"])
    want = chip_smoke.decode_kernel_gates(run, (4,))
    assert run["launches"]["paged_append_decode_attention"] == want > 0


@pytest.mark.cuda
def test_engine_trace_rows_on_the_card(card):
    import chip_smoke

    run = chip_smoke.perf_run(["--engine-trace", "--engine-requests", "8",
                               "--device", "cuda"])
    chip_smoke.engine_trace_gates(run["rows"])
    chip_smoke.no_own_k5_k6(run["launches"], "the engine-trace rows")
    assert run["launches"]["paged_append_decode_attention"] > 0
