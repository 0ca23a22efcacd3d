"""Card test of the operations plane (torch only: it runs where the card
is, without JAX).  Marked `cuda`; it skips here, where there is no card.
Run from the repo root: it imports `chip_smoke`.

A head with no GPU, `AutoscalerV2` over the local provider with one
`{"GPU": 1}` node type, and the ops plane's workflow
(`chip_smoke.gpt2_workflow_steps`) at GPT-2's full width cut to 2
layers: the `num_gpus=1` step runs on the node the autoscaler brings up,
sees one device, launches K1 / K2 (2 x 2 and 2 a step) with no plain
dispatch, and `resume` after `report`'s injected failure returns its
stored results without running it again.
"""

import os
import threading
import time

import pytest
import torch

from test_torch_waits import within

STEPS, N_LAYER, BATCH, SEQ = 2, 2, 2, 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the workflow's GPU step launches "
                    "the flash kernels")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gpu_step_on_an_autoscaled_node_survives_resume(card, tmp_path):
    import cloudpickle

    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.autoscaler import (AutoscalerV2, AutoscalerV2Config,
                                          LocalNodeProvider,
                                          NodeTypeConfigV2)
    from ray_tpu_torch.util import state

    info = rt.init(num_workers=2, num_cpus=4, num_gpus=0)
    stop = threading.Event()
    provider = LocalNodeProvider(info["controller_addr"])
    try:
        scaler = AutoscalerV2(provider, AutoscalerV2Config(
            node_types={"gpu_worker": NodeTypeConfigV2(
                num_cpus=4, resources={"GPU": 1}, num_workers=1,
                max_slices=1)},
            max_hosts=1, idle_timeout_s=60.0))
        threading.Thread(target=scaler.run, daemon=True,
                         kwargs={"interval_s": 0.5,
                                 "stop_event": stop}).start()
        store = str(tmp_path / "wf")
        workflow.init_storage(store)
        flag = str(tmp_path / "report.fail")
        open(flag, "w").close()
        make_batch, train, report = chip_smoke.gpt2_workflow_steps(
            "cuda", {"n_layer": N_LAYER}, STEPS)
        dag = report.bind(train.bind(make_batch.bind(0, BATCH, SEQ, 50257)),
                          flag)
        with pytest.raises(Exception, match="injected failure"):
            within(300.0, lambda: workflow.run(dag, workflow_id="ops"))
        meta = workflow.get_metadata("ops")
        [key] = [k for k, s in meta["steps"].items() if s["name"] == "train"]
        with open(os.path.join(store, "ops", "tasks", key + ".pkl"),
                  "rb") as f:
            stored = cloudpickle.load(f)
        [pid] = provider.non_terminated_nodes()
        assert stored["node_id"] == provider.runtime_node_id(pid)
        assert stored["seen"]["device_count"] == 1, stored["seen"]
        assert stored["launches"] == {
            "flash_fwd": STEPS * N_LAYER * 2,
            "flash_bwd_fused": STEPS * N_LAYER,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}, stored["launches"]
        assert stored["plain_dispatches"] == 0

        os.remove(flag)
        resumed = within(120.0, lambda: workflow.resume("ops"))
        assert resumed == {k: stored[k] for k in resumed}
        assert workflow.get_metadata("ops")["steps"][key] == \
            meta["steps"][key]
        # the owner's task events reach the controller on its next
        # flush: wait for train's, then hold it to one execution
        deadline = time.time() + 30
        runs = []
        while not runs and time.time() < deadline:
            runs = state.list_tasks(name="train", state="FINISHED")
            time.sleep(0.2)
        assert len(runs) == 1, runs
    finally:
        stop.set()
        for pid in provider.non_terminated_nodes():
            provider.terminate_node(pid)
        rt.shutdown()
