"""EnvRunnerGroup: fleet of sampling actors with fault tolerance.

Reference: `rllib/env/env_runner_group.py:71` — owns N remote EnvRunner
actors, broadcasts weights, gathers samples, and restores failed runners
(reference: `algorithm.py:235` restore_workers).

Production shape (this repo's BASELINE config #3 workload): sample
batches move as OBJECT-PLANE REFERENCES — each runner `rt.put`s its
rollout locally and returns a small envelope, so a fleet of
tens-to-hundreds of CPU actors fans small envelopes (not megabytes)
into the driver's owner shards, and the learner fetches batch payloads
zero-copy from shm.  Weights broadcast the same way: ONE `rt.put` per
version, every runner pulls at most once per version
(`EnvRunner.set_weights_ref`).

Exactly-once accounting: every consumed batch is recorded in a
`SampleLedger` under its (slot, incarnation, seq) key.  Runner
replacement bumps the incarnation, so a dead runner's in-flight batches
can never collide with — or be double-counted against — its
replacement's.  With `deterministic_replay=True` (sync fleets), a
replacement rebuilds the dead runner's exact env/rng state by replaying
its weights history, so a kill-storm run consumes bit-identical batches
to an unkilled control run.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.metrics import metric_defs as _mdefs
from ray_tpu_torch.rllib.env.env_runner import (
    EnvRunner,
    flatten_tree,
)

logger = logging.getLogger(__name__)


class DuplicateSampleError(RuntimeError):
    """A sample batch was consumed twice — the exactly-once fleet
    accounting is broken.  NEVER swallowed by the fault-tolerant
    consumption paths (which treat other fetch failures as a dead
    producer): this is a correctness bug, not a runner death."""


class SampleLedger:
    """Exactly-once consumption ledger for the runner fleet.

    Every batch the learner side consumes is recorded under its
    (slot, incarnation, seq) identity; a duplicate delivery raises —
    double-counting a rollout would silently skew both the bench
    numbers and the training distribution."""

    def __init__(self):
        self._seen: set = set()
        self.batches = 0
        self.env_steps = 0
        self.bytes = 0
        self.sample_s = 0.0

    def record(self, meta: Dict[str, Any]) -> None:
        key = (meta["slot"], meta["incarnation"], meta["seq"])
        if key in self._seen:
            raise DuplicateSampleError(
                f"duplicate sample batch consumed: {key} — the "
                "exactly-once fleet accounting is broken"
            )
        self._seen.add(key)
        self.batches += 1
        self.env_steps += int(meta["env_steps"])
        self.bytes += int(meta.get("bytes", 0))
        self.sample_s += float(meta.get("sample_s", 0.0))
        _mdefs.inc("rt_rllib_env_steps_total", float(meta["env_steps"]))
        _mdefs.inc("rt_rllib_sample_batch_bytes_total",
                   float(meta.get("bytes", 0)))

    def snapshot(self) -> Dict[str, float]:
        return {
            "batches": float(self.batches),
            "env_steps": float(self.env_steps),
            "bytes": float(self.bytes),
            "sample_s": self.sample_s,
            "unique": float(len(self._seen)),
        }


class EnvRunnerGroup:
    def __init__(self, env: Any, num_runners: int, num_envs_per_runner: int,
                 rollout_length: int, seed: int = 0,
                 env_kwargs: Optional[Dict] = None,
                 connector: Any = None,
                 deterministic_replay: bool = False):
        self._env = env
        self._num_runners = num_runners
        self._num_envs = num_envs_per_runner
        self._T = rollout_length
        self._seed = seed
        self._env_kwargs = env_kwargs or {}
        self._connector_factory = connector
        self._connector_base: Dict = {}  # merged fleet connector state
        self._runners: List = []
        self._incarnations: List[int] = [0] * num_runners
        self._weights: Any = None
        self._weights_version = 0
        #: one boxed `{"ref": ObjectRef}` per published version (1-based
        #: version v lives at index v-1).  With deterministic_replay the
        #: whole history is retained (replacements replay it); otherwise
        #: only the latest ref is kept alive.
        self._weights_refs: List[Dict[str, Any]] = []
        self._deterministic_replay = deterministic_replay
        if deterministic_replay and connector is not None:
            raise ValueError(
                "deterministic_replay rebuilds runner state from the "
                "seed + weights history alone; stateful connector "
                "pipelines receive out-of-band set_connector_state "
                "pushes that replay cannot reproduce — use one or the "
                "other"
            )
        self.ledger = SampleLedger()
        self._replacements = 0
        # compiled-DAG channel plane (use_compiled_dag) state
        self._chan_mode = False
        self._chan_id = ""
        self._sample_chans: Dict[int, Any] = {}
        self._weights_chans: Dict[int, Any] = {}
        self._chan_loop_refs: Dict[int, Any] = {}
        self._chan_loops_reaped: set = set()
        self._chan_rr = 0
        self._chan_last_health = 0.0
        self._chan_attempt = 0  # makes every bootstrap's ring names
        # unique, so a slow-exiting failed loop can never close the
        # rings of the retry that replaced it
        for i in range(num_runners):
            self._runners.append(self._make_runner(i))
        _mdefs.set_gauge("rt_rllib_env_runners", float(num_runners))

    def _make_runner(self, idx: int):
        return rt.remote(EnvRunner).options(num_cpus=1).remote(
            self._env, self._num_envs, self._T,
            seed=self._seed + idx * 10_000, env_kwargs=self._env_kwargs,
            connector=self._connector_factory,
            slot=idx, incarnation=self._incarnations[idx],
        )

    def env_spec(self) -> Dict[str, int]:
        return rt.get(self._runners[0].env_spec.remote())

    # -- weights broadcast (by reference: one put per version) ---------
    def _publish_weights(self, params_np: Any) -> Dict[str, Any]:
        self._weights = params_np
        self._weights_version += 1
        # inline=False: small policies would otherwise live in the
        # driver's memory and every runner pull would be an owner RPC
        # through the daemon (N round-trips per version); through shm,
        # node-local runners read the one published copy zero-copy
        boxed = {"ref": rt.put(params_np, inline=False)}
        if self._deterministic_replay:
            self._weights_refs.append(boxed)
        else:
            self._weights_refs = [boxed]
        return boxed

    def sync_weights(self, params_np: Any):
        if self._chan_mode:
            # resident loops occupy the actors: the RPC broadcast
            # would queue behind them forever — ride the channels
            self.sync_weights_channel(params_np)
            return
        boxed = self._publish_weights(params_np)
        refs = [
            r.set_weights_ref.remote(boxed, self._weights_version)
            for r in self._runners
        ]
        rt.wait(refs, num_returns=len(refs), timeout=30)

    def sync_weights_async(self, params_np: Any):
        """Non-blocking weight broadcast: runners adopt the new weights
        for their NEXT rollout; in-flight rollouts stay stale (V-trace
        or PPO's ratio clip absorbs one version of staleness)."""
        boxed = self._publish_weights(params_np)
        for r in self._runners:
            r.set_weights_ref.remote(boxed, self._weights_version)
        # connector stats ride the same cadence on the async path
        if (
            self._connector_factory is not None
            and self._weights_version % 8 == 0
        ):
            self.sync_connector_states()

    def _bootstrap_replacement(self, idx: int) -> bool:
        """Bring a fresh incarnation up to date: deterministic replay of
        the dead runner's weights history when enabled, else just the
        latest weights.  A bootstrap failure (the replacement itself
        killed under a sustained storm) is survivable: the un-weighted
        runner's next sample fails, which routes back through the
        replacement path — the fleet self-heals once kills stop."""
        try:
            if (self._deterministic_replay
                    and self._replay_module is not None):
                history = self._weights_refs[:-1]
                if history:
                    rt.get(self._runners[idx].replay.remote(
                        self._replay_module, history,
                    ), timeout=300)
            if self._weights_refs:
                rt.get(self._runners[idx].set_weights_ref.remote(
                    self._weights_refs[-1], self._weights_version,
                ), timeout=60)
            return True
        except Exception as e:
            logger.debug(
                "replacement runner %d bootstrap failed (%s); its next "
                "sample re-triggers replacement", idx, e,
            )
            return False

    def _replace_runner_sync(self, idx: int):
        self._incarnations[idx] += 1
        self._replacements += 1
        self._runners[idx] = self._make_runner(idx)
        self._bootstrap_replacement(idx)
        _mdefs.set_gauge("rt_rllib_env_runners", float(self._num_runners))

    # module used for deterministic replay (set by sample()/streams)
    _replay_module: Any = None

    # -- synchronous fleet sampling ------------------------------------
    def sample(self, module_def, explore=None) -> List[Dict[str, np.ndarray]]:
        """One rollout from every runner, shipped by reference.

        Failed runners are replaced in place; with deterministic_replay
        their round is RETRIED on the replacement (the replayed state
        regenerates the identical rollout), otherwise it is skipped
        this round (reference: EnvRunnerGroup fault tolerance)."""
        self._replay_module = module_def
        refs = [r.sample_ref.remote(module_def, explore)
                for r in self._runners]
        out: List[Dict[str, np.ndarray]] = []
        for i, ref in enumerate(refs):
            attempts = 0
            while True:
                try:
                    envelope = rt.get(ref, timeout=120)
                    out.append(self._consume(envelope))
                    break
                except DuplicateSampleError:
                    raise  # accounting bug, not a runner death
                except Exception as e:
                    attempts += 1
                    logger.debug(
                        "env runner %d failed mid-sample (%s); replacing",
                        i, e,
                    )
                    self._replace_runner_sync(i)
                    if not (self._deterministic_replay and attempts < 3):
                        break
                    ref = self._runners[i].sample_ref.remote(
                        module_def, explore
                    )
        if not out:
            raise RuntimeError("all env runners failed")
        # fleet-wide connector statistics converge once per sampling
        # round — centralized here so EVERY algorithm built on the
        # group gets it (not a per-algorithm opt-in)
        if self._connector_factory is not None:
            self.sync_connector_states()
        return out

    def fetch(self, envelope: Dict[str, Any]
              ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """Fetch an envelope's batch payload from the object plane and
        record it in the exactly-once ledger.  Returns (meta, batch).

        The ledger records AFTER the payload fetch succeeds: a batch
        whose producer died between envelope delivery and payload read
        is never counted as consumed."""
        batch = rt.get(envelope["batch"], timeout=120)
        self.ledger.record(envelope["meta"])
        return envelope["meta"], batch

    def _consume(self, envelope: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return self.fetch(envelope)[1]

    # -- async ref stream (the sample/train-overlap shape) -------------
    def start_ref_stream(self, module_def, *, inflight_per_runner: int = 2,
                         explore=None):
        """Keep every runner busy with up to `inflight_per_runner`
        outstanding sample_ref() calls (reference: IMPALA's async
        request manager, `impala.py` AsyncRequestsManager).  Batches
        land in the object plane; `collect()` hands back envelopes."""
        if self._deterministic_replay:
            raise ValueError(
                "deterministic_replay assumes one rollout per weights "
                "version (the sync fleet shape); the async ref stream "
                "pipelines several rollouts per version, so a replayed "
                "replacement would diverge from the dead incarnation — "
                "use the sync sample() path for deterministic "
                "replacement, or disable it for overlap"
            )
        self._replay_module = module_def
        self._async_module = module_def
        self._async_explore = explore
        self._async_inflight = inflight_per_runner
        self._pending: Dict[Any, int] = {}
        self._inflight_count = [0] * self._num_runners
        for i in range(self._num_runners):
            for _ in range(inflight_per_runner):
                self._submit_async(i)

    # back-compat alias (IMPALA's original entry point)
    def start_async_sampling(self, module_def, *,
                             inflight_per_runner: int = 2, explore=None):
        self.start_ref_stream(module_def,
                              inflight_per_runner=inflight_per_runner,
                              explore=explore)

    def _submit_async(self, idx: int):
        ref = self._runners[idx].sample_ref.remote(
            self._async_module, self._async_explore
        )
        self._pending[ref] = idx
        self._inflight_count[idx] += 1

    def collect(self, max_batches: int = 4,
                timeout: Optional[float] = 120.0,
                block: bool = True) -> List[Dict[str, Any]]:
        """Collect completed envelopes (blocking for at least one when
        `block`) and immediately re-dispatch their runners — the
        learner never waits for the slowest runner.  Dead runners are
        replaced in place (fresh incarnation; their other in-flight
        refs are dropped, so the ledger stays exactly-once)."""
        assert self._pending, "call start_ref_stream first"
        out: List[Dict[str, Any]] = []
        if block:
            ready, rest = rt.wait(
                list(self._pending), num_returns=1, timeout=timeout
            )
        else:
            ready, rest = rt.wait(
                list(self._pending),
                num_returns=min(max_batches, len(self._pending)),
                timeout=0,
            )
        if block and rest and max_batches > 1:
            more, _ = rt.wait(
                rest,
                num_returns=min(max_batches - 1, len(rest)),
                timeout=0,
            )
            ready = list(ready) + list(more)
        for ref in ready:
            idx = self._pending.pop(ref, None)
            if idx is None:
                # its runner was replaced earlier in this loop (its
                # other in-flight refs were dropped with it)
                continue
            self._inflight_count[idx] -= 1
            try:
                out.append(rt.get(ref))
            except Exception as e:
                logger.debug(
                    "env runner %d died with a rollout in flight (%s); "
                    "replacing", idx, e,
                )
                self._replace_runner(idx)
            self._submit_async(idx)
        return out

    def get_ready_samples(self, max_batches: int = 4,
                          timeout: Optional[float] = 120.0
                          ) -> List[Dict[str, np.ndarray]]:
        """Envelope stream + payload fetch in one call — the IMPALA
        surface.  Every returned batch is ledger-recorded."""
        out = []
        for envelope in self.collect(max_batches=max_batches,
                                     timeout=timeout):
            try:
                out.append(self._consume(envelope))
            except DuplicateSampleError:
                raise  # accounting bug, not a runner death
            except Exception as e:
                # the producing runner died between envelope delivery
                # and payload fetch; its replacement resamples
                logger.debug("sample payload fetch failed: %s", e)
        return out

    def _replace_runner(self, idx: int):
        # drop the dead runner's other pending refs so they don't
        # resubmit onto the replacement twice
        for ref, i in list(self._pending.items()):
            if i == idx:
                del self._pending[ref]
        self._inflight_count[idx] = 0
        self._incarnations[idx] += 1
        self._replacements += 1
        self._runners[idx] = self._make_runner(idx)
        self._bootstrap_replacement(idx)
        _mdefs.set_gauge("rt_rllib_env_runners", float(self._num_runners))
        while self._inflight_count[idx] < self._async_inflight - 1:
            self._submit_async(idx)

    # -- compiled-DAG channel plane (use_compiled_dag=True) ------------
    def start_channel_stream(self, module_def, *, explore=None):
        """The fast-plane analog of start_ref_stream: every runner
        hosts a RESIDENT sample loop (`run_sample_channel_loop`) and
        the runner->learner sample hop + the weights broadcast ride shm
        tensor channels instead of per-call actor RPCs.  Exactly-once
        accounting is unchanged: every batch still carries its (slot,
        incarnation, seq) meta and is ledger-recorded on consumption —
        channel delivery consumes each published message exactly once
        by construction."""
        if self._deterministic_replay:
            raise ValueError(
                "deterministic_replay replays the weights-ref history "
                "over the actor-call path; the channel plane broadcasts "
                "by value — use one or the other"
            )
        if self._weights is None:
            raise RuntimeError("sync_weights before start_channel_stream")
        import uuid

        self._replay_module = module_def
        self._chan_mode = True
        self._chan_id = uuid.uuid4().hex[:8]
        self._chan_module = module_def
        self._chan_explore = explore
        try:
            for i in range(self._num_runners):
                self._start_runner_channels(i)
        except BaseException:
            # mid-fleet bootstrap failure: roll the whole plane back
            # (already-started loops + rings) — a half-started stream
            # would leak pinned rings and queue a second resident loop
            # behind the first on any retry
            try:
                self.stop_channel_stream()
            except Exception as e:
                logger.debug("channel stream rollback failed: %s", e)
            raise

    def _start_runner_channels(self, idx: int):
        from ray_tpu_torch.core.runtime import get_runtime
        from ray_tpu_torch.dag.channel import Channel
        from ray_tpu_torch.dag.compiled_dag import resolve_actor_node

        # force placement: a fresh (replacement) runner has no address
        # until it is scheduled, and its ring must land on its node
        rt.get(self._runners[idx].ping.remote(), timeout=60)
        self._chan_attempt += 1
        base = (f"rl{self._chan_id}_r{idx}i{self._incarnations[idx]}"
                f"a{self._chan_attempt}")
        s_ref = (base + "s", get_runtime().node_id)  # ring at the learner
        w_ref = (base + "w", resolve_actor_node(self._runners[idx]))
        template, leaves = flatten_tree(self._weights)
        plan = {
            "sample_chan": s_ref,
            "weights_chan": w_ref,
            "weights_ring_slots": 4,
            "module": self._chan_module,
            "explore": self._chan_explore,
            "weights_template": template,
        }
        s_ch = Channel(*s_ref)
        w_ch = Channel(*w_ref, ring_slots=4)
        try:
            loop_ref = self._runners[idx].run_sample_channel_loop.remote(
                plan
            )
            # seed the incarnation with the current version (its loop
            # blocks on the weights channel until one arrives)
            w_ch.write_tensors(
                leaves, extra={"version": self._weights_version}
            )
        except BaseException:
            # register NOTHING on a partial bootstrap: a half-wired
            # runner would look healthy (rings present, forever idle)
            # and the self-healing would never retry it
            for ch in (s_ch, w_ch):
                try:
                    ch.destroy()
                except Exception as e:
                    logger.debug("bootstrap ring cleanup failed: %s", e)
            raise
        self._sample_chans[idx] = s_ch
        self._weights_chans[idx] = w_ch
        self._chan_loop_refs[idx] = loop_ref

    def _try_read_channel(self, idx: int, timeout_s: float):
        """One bounded read from runner `idx`'s sample channel.
        Returns (meta, batch), or None when nothing is ready.  A read
        failure other than timeout means the producer died — replace
        it in place (fresh incarnation, fresh rings)."""
        from ray_tpu_torch.dag.channel import ChannelPollTimeout

        ch = self._sample_chans.get(idx)
        if ch is None:
            return None
        try:
            batch, meta = ch.read_tensors(timeout_s=timeout_s)
        except ChannelPollTimeout:
            return None
        except Exception as e:  # ChannelClosed or any reader failure:
            # either way the producer is gone (or its stream is
            # corrupt) — replace it in place
            logger.debug(
                "sample channel of runner %d failed (%s); replacing",
                idx, e,
            )
            self._replace_runner_channel(idx)
            return None
        self.ledger.record(meta)
        return meta, batch

    def _check_channel_loops(self):
        """Reap failed resident loops (SIGKILLed runner: its channel
        goes silent but its loop TASK fails) and replace their
        runners."""
        from ray_tpu_torch.dag.compiled_dag import reap_failed_loop_tasks

        by_ref = {ref: idx for idx, ref in self._chan_loop_refs.items()}
        for ref, e in reap_failed_loop_tasks(list(by_ref),
                                             self._chan_loops_reaped):
            idx = by_ref[ref]
            if self._chan_loop_refs.get(idx) is not ref:
                continue  # already replaced
            logger.debug(
                "runner %d sample loop died (%s); replacing", idx, e,
            )
            self._replace_runner_channel(idx)

    def _replace_runner_channel(self, idx: int):
        for chans in (self._sample_chans, self._weights_chans):
            ch = chans.pop(idx, None)
            if ch is not None:
                try:
                    ch.destroy()
                except Exception as e:
                    logger.debug("stale ring destroy failed: %s", e)
        self._chan_loop_refs.pop(idx, None)
        # the replaced actor may still be ALIVE (transient read/ping
        # failure): kill it, or every replacement leaks a resident
        # runner process + its vector envs until cluster shutdown
        try:
            rt.kill(self._runners[idx])
        except Exception as e:
            logger.debug("old runner %d kill failed: %s", idx, e)
        self._incarnations[idx] += 1
        self._replacements += 1
        self._runners[idx] = self._make_runner(idx)
        try:
            self._start_runner_channels(idx)
        except Exception as e:
            # replacement itself died (sustained storm): the next empty
            # collect pass re-detects the missing channels and retries
            logger.debug(
                "replacement runner %d channel bootstrap failed (%s); "
                "will retry on next stall", idx, e,
            )
        _mdefs.set_gauge("rt_rllib_env_runners", float(self._num_runners))

    def collect_channel(self, max_batches: int = 4,
                        timeout: Optional[float] = 120.0,
                        block: bool = True) -> List[Tuple[Dict, Dict]]:
        """Collect ready (meta, batch) pairs off the sample channels
        (blocking for at least one when `block`).  Every returned batch
        is ledger-recorded; DuplicateSampleError propagates (accounting
        bug, never a runner death)."""
        assert self._chan_mode, "call start_channel_stream first"
        out: List[Tuple[Dict, Dict]] = []
        deadline = (None if timeout is None
                    else time.monotonic() + max(0.0, timeout))
        # a dead runner's channel goes silent while survivors keep the
        # stream busy, so liveness CANNOT wait for a fully-empty pass —
        # sweep the loop refs on a cheap time throttle as well
        if time.monotonic() - self._chan_last_health > 2.0:
            self._heal_channel_fleet()
        while True:
            # sweep everything that is already published
            for idx in sorted(self._sample_chans):
                while len(out) < max_batches:
                    got = self._try_read_channel(idx, timeout_s=0.001)
                    if got is None:
                        break
                    out.append(got)
                if len(out) >= max_batches:
                    return out
            if out or not block:
                return out
            if deadline is not None and time.monotonic() >= deadline:
                return out
            # nothing ready: look for dead producers, then park briefly
            # on one channel round-robin (readers cost nothing while
            # parked — the ring condvar wakes them).  The heal is
            # throttled (~2s) and an empty fleet pays the park as a
            # plain sleep — a persistently failing bootstrap must not
            # spawn replacement actors in a tight loop
            if time.monotonic() - self._chan_last_health > 2.0:
                self._heal_channel_fleet()
            if not self._sample_chans:
                time.sleep(0.25)  # rtlint: disable=RT006 — not a
                # retry loop: paced wait for the throttled heal above
                continue
            idxs = sorted(self._sample_chans)
            self._chan_rr = (self._chan_rr + 1) % len(idxs)
            got = self._try_read_channel(idxs[self._chan_rr], timeout_s=0.25)
            if got is not None:
                out.append(got)

    def _heal_channel_fleet(self):
        """Reap failed resident loops and re-bootstrap any runner index
        with no rings (a storm can kill a replacement mid-bootstrap)."""
        self._chan_last_health = time.monotonic()
        self._check_channel_loops()
        for idx in range(self._num_runners):
            if self._chan_mode and idx not in self._sample_chans:
                try:
                    self._start_runner_channels(idx)
                except Exception as e:
                    logger.debug(
                        "runner %d channel re-bootstrap failed (%s); "
                        "replacing the actor", idx, e,
                    )
                    self._replace_runner_channel(idx)

    def sync_weights_channel(self, params_np: Any):
        """Non-blocking weights broadcast over the reverse channels:
        one tensor publication per runner ring.  A full ring (runner
        deep in a rollout, several unread versions queued) SKIPS that
        runner for this version — it drains to the newest on its next
        boundary, the same bounded staleness the ref path allows."""
        assert self._chan_mode, "call start_channel_stream first"
        self._weights = params_np
        self._weights_version += 1
        _template, leaves = flatten_tree(params_np)
        for idx, ch in list(self._weights_chans.items()):
            try:
                ch.write_tensors(
                    leaves, extra={"version": self._weights_version},
                    timeout_s=0.05,
                )
            except TimeoutError:
                logger.debug(
                    "weights ring of runner %d full at v%d; it adopts "
                    "the newest on drain", idx, self._weights_version,
                )
            except Exception as e:
                logger.debug(
                    "weights publish to runner %d failed (%s); stall "
                    "detection will replace it", idx, e,
                )

    def stop_channel_stream(self):
        """Tear the channel plane down: close the weights rings (the
        resident loops exit at their next rollout boundary), drain
        sample rings so a writer blocked on a full ring unwedges, then
        free every ring."""
        if not self._chan_mode:
            return
        from ray_tpu_torch.dag.channel import ChannelPollTimeout

        for ch in self._weights_chans.values():
            ch.close()
        deadline = time.monotonic() + 20.0
        pending = dict(self._sample_chans)
        while pending and time.monotonic() < deadline:
            for idx, ch in list(pending.items()):
                try:
                    ch.read_tensors(timeout_s=0.05)
                except ChannelPollTimeout:
                    continue
                except Exception as e:  # ChannelClosed (producer
                    # exited) or a dead producer's broken stream
                    logger.debug("sample ring %d drained (%s)", idx, e)
                    del pending[idx]
        refs = list(self._chan_loop_refs.values())
        if refs:
            try:
                rt.wait(refs, num_returns=len(refs), timeout=15)
            except Exception as e:
                logger.debug("channel loop drain wait failed: %s", e)
        for chans in (self._sample_chans, self._weights_chans):
            for ch in chans.values():
                try:
                    ch.destroy()
                except Exception as e:
                    logger.debug("ring destroy failed: %s", e)
            chans.clear()
        self._chan_loop_refs.clear()
        self._chan_loops_reaped.clear()
        self._chan_mode = False

    # -- connector state (reference: connector aggregation across
    # EnvRunners) ------------------------------------------------------
    def sync_connector_states(self):
        """Merge per-runner connector DELTAS over the tracked fleet
        base and push the result back (reference: connector state
        aggregation across EnvRunners).  Runners report only samples
        seen since their last sync, so shared history is never
        double-counted."""
        if self._connector_factory is None:
            return None
        refs = [r.get_connector_state.remote() for r in self._runners]
        states = [self._connector_base]
        for ref in refs:
            try:
                states.append(rt.get(ref, timeout=30))
            except Exception as e:
                logger.debug("connector state fetch failed: %s", e)
                states.append({})
        proto = self._connector_factory()
        merged = proto.merge_states(states)
        if merged:
            self._connector_base = merged
            set_refs = [r.set_connector_state.remote(merged)
                        for r in self._runners]
            rt.wait(set_refs, num_returns=len(set_refs), timeout=30)
        return merged

    def connector_state(self) -> Optional[Dict]:
        """Fleet connector state for checkpoints (the merged base; a
        restored policy must act on the SAME normalization it trained
        with)."""
        if self._connector_factory is None:
            return None
        return self._connector_base

    def restore_connector_state(self, state: Optional[Dict]):
        if self._connector_factory is None or not state:
            return
        self._connector_base = state
        refs = [r.set_connector_state.remote(state)
                for r in self._runners]
        rt.wait(refs, num_returns=len(refs), timeout=30)

    def pop_metrics(self) -> List[Dict[str, float]]:
        metrics: List[Dict[str, float]] = []
        refs = [r.pop_metrics.remote() for r in self._runners]
        for ref in refs:
            try:
                metrics.extend(rt.get(ref, timeout=30))
            except Exception as e:
                logger.debug("episode metrics fetch failed: %s", e)
        return metrics

    def ping_fleet(self, timeout: float = 30.0) -> int:
        """Healthy-runner count (chaos tests assert full restoration)."""
        alive = 0
        for r in self._runners:
            try:
                if rt.get(r.ping.remote(), timeout=timeout):
                    alive += 1
            except Exception as e:
                logger.debug("runner ping failed: %s", e)
        return alive

    @property
    def num_runners(self) -> int:
        return self._num_runners

    @property
    def num_replacements(self) -> int:
        return self._replacements

    @property
    def weights_version(self) -> int:
        return self._weights_version

    def stop(self):
        try:
            self.stop_channel_stream()
        except Exception as e:
            logger.debug("channel stream stop failed: %s", e)
        for r in self._runners:
            try:
                rt.kill(r)
            except Exception as e:
                logger.debug("runner kill on stop failed: %s", e)
        _mdefs.set_gauge("rt_rllib_env_runners", 0.0)
