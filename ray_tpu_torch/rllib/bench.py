"""RLlib PPO fleet benchmark harness (BASELINE config #3).

The workload is the production shape the ROADMAP names: an
`EnvRunnerGroup` fleet of CPU sampling actors streaming rollouts as
object-plane references into the learner, with async sample/train
overlap.  It deliberately stresses the n:n small-envelope actor-call
path on top of the sharded owner plane.  The JAX package runs its
learner gang over XLA's forced host devices; here the learner sits on
`device` (the card by default); its default gang is 1.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional


def measure_rllib_ppo(*, num_runners: int = 8, envs_per_runner: int = 16,
                      rollout_len: int = 64, minibatch: int = 2048,
                      epochs: int = 2, gang_devices: int = 1,
                      iters: int = 4, seed: int = 0,
                      compare_sync: bool = True,
                      include_dag: bool = False,
                      num_workers: Optional[int] = None,
                      device: Any = None
                      ) -> Dict[str, Dict[str, float]]:
    """Run the fleet bench; returns {"rllib_ppo": async_row[,
    "rllib_ppo_sync": sync_row][, "rllib_ppo_dag": compiled-DAG row]}.
    The dag row is the same overlap shape with `use_compiled_dag=True`:
    sample hop + weights broadcast over shm tensor channels into
    resident runner loops instead of per-call actor RPCs.  Caller owns
    no cluster — this inits/shuts down its own.  `device` is the
    learner's (None: the card)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import PPOConfig

    rt.init(num_workers=num_workers or (num_runners + 2),
            num_cpus=max(16, 2 * num_runners))
    try:
        out: Dict[str, Dict[str, float]] = {}
        out["rllib_ppo"] = _run_mode(
            PPOConfig, True, num_runners, envs_per_runner, rollout_len,
            minibatch, epochs, gang_devices, iters, seed, device=device,
        )
        if compare_sync:
            out["rllib_ppo_sync"] = _run_mode(
                PPOConfig, False, num_runners, envs_per_runner,
                rollout_len, minibatch, epochs, gang_devices, iters, seed,
                device=device,
            )
        if include_dag:
            out["rllib_ppo_dag"] = _run_mode(
                PPOConfig, True, num_runners, envs_per_runner,
                rollout_len, minibatch, epochs, gang_devices, iters,
                seed, use_dag=True, device=device,
            )
        return out
    finally:
        rt.shutdown()


def _run_mode(PPOConfig, overlap: bool, num_runners: int,
              envs_per_runner: int, rollout_len: int, minibatch: int,
              epochs: int, gang_devices: int, iters: int,
              seed: int, use_dag: bool = False,
              device: Any = None) -> Dict[str, float]:
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=num_runners,
                     num_envs_per_env_runner=envs_per_runner,
                     rollout_fragment_length=rollout_len)
        .learners(num_learner_devices=gang_devices, device=device)
        .training(lr=3e-4, minibatch_size=minibatch, num_epochs=epochs,
                  sample_train_overlap=overlap, use_compiled_dag=use_dag)
        .debugging(seed=seed)
        .build()
    )
    try:
        algo.train()  # warmup: compiles the update, primes the stream
        group = algo.env_runner_group
        led0 = group.ledger.snapshot()
        steps = updates = 0
        busy_s = wait_s = 0.0
        losses = []
        t0 = time.perf_counter()
        for _ in range(iters):
            r = algo.train()
            steps += int(r["num_env_steps_sampled"])
            updates += int(r["num_learner_updates"])
            busy_s += float(r.get("sample_busy_s", 0.0))
            wait_s += float(r.get("sample_wait_s", 0.0))
            losses.append(float(r["total_loss"]))
        wall_s = time.perf_counter() - t0
        led1 = group.ledger.snapshot()
        ledger_steps = led1["env_steps"] - led0["env_steps"]
        ledger_batches = led1["batches"] - led0["batches"]
        ledger_unique = led1["unique"] - led0["unique"]
        row: Dict[str, float] = {
            "env_steps_per_s": steps / wall_s,
            "updates_per_s": updates / wall_s,
            "env_steps": float(steps),
            "updates": float(updates),
            "wall_s": wall_s,
            "iters": float(iters),
            "runners": float(num_runners),
            "gang_devices": float(algo.learner_group.num_gang_devices),
            "overlap": float(overlap),
            # exactly-once proof: every env step the training loop
            # counted is ledger-recorded exactly once, and no batch was
            # consumed twice
            "ledger_env_steps": ledger_steps,
            "ledger_batches": ledger_batches,
            "accounting_exact": float(
                steps == int(ledger_steps)
                and ledger_batches == ledger_unique
            ),
            "replacements": float(group.num_replacements),
            "final_loss": losses[-1],
            "use_compiled_dag": float(use_dag),
        }
        if overlap:
            hidden_s = max(0.0, busy_s - wait_s)
            row.update({
                "sample_busy_s": busy_s,
                "sample_wait_s": wait_s,
                "overlap_ratio": (hidden_s / busy_s) if busy_s else 0.0,
            })
        return row
    finally:
        algo.stop()
