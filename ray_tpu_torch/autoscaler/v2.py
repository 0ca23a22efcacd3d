"""Autoscaler v2: instance-manager architecture with atomic TPU-slice
scale-up.

Reference: `python/ray/autoscaler/v2/autoscaler.py:42` +
`v2/instance_manager/` + `v2/scheduler.py` — a declarative pipeline:

1. an **instance table** tracks every managed machine through an
   explicit lifecycle state machine (versioned updates, invalid
   transitions rejected);
2. a pure **scheduler** maps (pending demand, pending gang demand,
   current instances, node-type config) -> launch/terminate decisions —
   no side effects, unit-testable in isolation;
3. a **reconciler** executes decisions against the NodeProvider and
   folds provider/cluster reality back into the table.

TPU-first inversion (SURVEY §7): the unit of scale-up for gang demand is
an **ICI-connected slice**, not a host.  A multi-host slice is
provisioned as ONE unit — either every host launches and registers
within the ready timeout, or the whole slice is rolled back (the
reference approximates this with the `TPU-{pod}-head` resource hack,
`_private/accelerators/tpu.py:381`; GCP can allocate a slice atomically
as a single multi-host TPU VM, `GcpTpuNodeProvider.create_slice`).
Scale-down is also slice-granular: a slice is terminated only when ALL
its hosts sit idle past the timeout.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.core.task_spec import fits as _fits

# instance lifecycle (reference: `instance_manager/common.py`
# InstanceStatus — collapsed to the states this runtime distinguishes)
QUEUED = "QUEUED"            # decided, not yet requested from the provider
REQUESTED = "REQUESTED"      # provider create issued
RUNNING = "RUNNING"          # runtime node registered with the controller
TERMINATING = "TERMINATING"  # provider terminate issued
TERMINATED = "TERMINATED"    # gone (kept briefly for observability)

_TRANSITIONS = {
    QUEUED: {REQUESTED, TERMINATED},
    REQUESTED: {RUNNING, TERMINATING, TERMINATED},
    RUNNING: {TERMINATING, TERMINATED},
    TERMINATING: {TERMINATED},
    TERMINATED: set(),
}


@dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = QUEUED
    provider_id: Optional[str] = None
    runtime_node_id: Optional[str] = None  # controller's node id
    slice_id: Optional[str] = None  # set for every host of a gang slice
    # label stamped into node_config at launch; runtime nodes booted by
    # the provider carry it back through noded registration, letting
    # busy state be folded onto instances for providers that cannot map
    # provider ids to runtime node ids
    launch_id: Optional[str] = None
    # hosts this instance represents: 1 for per-host providers; N when
    # the provider allocates a whole N-host slice as ONE provider node
    # (GCP multi-host TPU VM)
    hosts: int = 1
    requested_at: float = 0.0
    last_busy_at: float = field(default_factory=time.time)
    version: int = 0


class InstanceManager:
    """The versioned instance table (reference:
    `instance_manager/instance_manager.py` — UpdateInstanceManagerState
    validates transitions and bumps a global version)."""

    def __init__(self):
        self._instances: Dict[str, Instance] = {}
        self.version = 0

    def add(self, inst: Instance):
        self._instances[inst.instance_id] = inst
        self.version += 1

    def update_status(self, instance_id: str, status: str):
        inst = self._instances[instance_id]
        if status not in _TRANSITIONS[inst.status]:
            raise ValueError(
                f"invalid transition {inst.status} -> {status} for "
                f"{instance_id}"
            )
        inst.status = status
        inst.version = self.version = self.version + 1

    def instances(self, *statuses: str) -> List[Instance]:
        if not statuses:
            return list(self._instances.values())
        return [i for i in self._instances.values() if i.status in statuses]

    def get(self, instance_id: str) -> Instance:
        return self._instances[instance_id]

    def prune_terminated(self, keep_s: float = 300.0):
        now = time.time()
        for iid, inst in list(self._instances.items()):
            if inst.status == TERMINATED and now - inst.last_busy_at > keep_s:
                del self._instances[iid]

    def slice_members(self, slice_id: str) -> List[Instance]:
        return [
            i for i in self._instances.values() if i.slice_id == slice_id
        ]


@dataclass
class NodeTypeConfigV2:
    """One launchable shape.  `hosts_per_slice > 1` makes it a
    multi-host TPU slice type: always provisioned and released whole."""

    num_cpus: float = 4
    resources: Dict[str, float] = field(default_factory=dict)
    num_workers: int = 2
    hosts_per_slice: int = 1
    max_slices: int = 8
    # provider-specific payload merged into the node config (e.g. the
    # GCP accelerator_type for the whole slice)
    provider_config: Dict[str, Any] = field(default_factory=dict)

    def host_provides(self) -> Dict[str, float]:
        return {"CPU": self.num_cpus, **self.resources}


@dataclass
class AutoscalerV2Config:
    node_types: Dict[str, NodeTypeConfigV2] = field(default_factory=dict)
    max_hosts: int = 16
    idle_timeout_s: float = 30.0
    # a REQUESTED slice whose hosts have not all registered by then is
    # rolled back whole
    # generous default: promotion is gated on REAL readiness (GCP state
    # READY / GKE pod Running), and cloud provisioning routinely takes
    # minutes (TPU-VM CREATE 2-5 min, GKE TPU node-pool scale-up up to
    # ~10) — a tighter timeout would reap+relaunch healthy boots in an
    # endless churn loop
    slice_ready_timeout_s: float = 900.0


@dataclass
class LaunchDecision:
    node_type: str
    hosts: int  # == hosts_per_slice of the type
    reason: str = ""


@dataclass
class SchedulingDecision:
    launches: List[LaunchDecision] = field(default_factory=list)
    terminations: List[str] = field(default_factory=list)  # instance ids


class ResourceDemandScheduler:
    """Pure decision function (reference: `v2/scheduler.py`
    ResourceDemandScheduler.schedule): no provider calls, no clock
    mutation — everything it needs rides in as arguments."""

    def __init__(self, config: AutoscalerV2Config):
        self.config = config

    def schedule(
        self,
        demands: List[Dict[str, float]],
        gangs: List[Dict[str, Any]],
        im: InstanceManager,
        now: float,
    ) -> SchedulingDecision:
        out = SchedulingDecision()
        live = im.instances(QUEUED, REQUESTED, RUNNING)
        hosts_up = sum(max(1, i.hosts) for i in live)
        slice_counts: Dict[str, int] = {}
        for inst in live:
            slice_counts[inst.node_type] = (
                slice_counts.get(inst.node_type, 0)
                + (1 if inst.slice_id is None else 0)
            )
        # count whole slices per type (a slice contributes once)
        seen_slices = set()
        for inst in live:
            if inst.slice_id is not None and inst.slice_id not in seen_slices:
                seen_slices.add(inst.slice_id)
                slice_counts[inst.node_type] = (
                    slice_counts.get(inst.node_type, 0) + 1
                )

        # capacity still inbound (QUEUED/REQUESTED) absorbs demand so a
        # slow-booting slice is not double-launched.  One entry per HOST
        # the instance represents (a GCP slice is one provider node for
        # N hosts — Instance.hosts carries the weight).
        spare: List[Dict[str, float]] = []
        for inst in im.instances(QUEUED, REQUESTED):
            cfg = self.config.node_types.get(inst.node_type)
            if cfg is not None:
                for _ in range(max(1, inst.hosts)):
                    spare.append(cfg.host_provides())

        def _pack(bundles: List[Dict[str, float]],
                  caps: List[Dict[str, float]]) -> bool:
            """All-or-nothing first-fit-decreasing bin-pack of bundles
            into per-host capacities; commits into `caps` on success."""
            trial = [dict(cap) for cap in caps]
            for need in sorted(bundles, key=lambda b: -sum(b.values())):
                hit = None
                for cap in trial:
                    if _fits(need, cap):
                        for k, v in need.items():
                            cap[k] = cap.get(k, 0.0) - v
                        hit = cap
                        break
                if hit is None:
                    return False
            for cap, t in zip(caps, trial):
                cap.clear()
                cap.update(t)
            return True

        def absorb_bundles(bundles: List[Dict[str, float]]) -> bool:
            """A gang absorbs into inbound capacity whole or not at all
            — per-bundle packing is what lets a multi-host gang match a
            multi-host inbound slice."""
            return _pack(bundles, spare)

        def absorb(need: Dict[str, float]) -> bool:
            return absorb_bundles([need])

        planned_hosts = 0

        def try_launch(tname: str, reason: str) -> Optional[List[Dict[str, float]]]:
            """Plan one slice launch; returns the new slice's per-host
            spare capacities (for the caller to consume) or None."""
            nonlocal planned_hosts
            cfg = self.config.node_types[tname]
            if slice_counts.get(tname, 0) >= cfg.max_slices:
                return None
            if (hosts_up + planned_hosts + cfg.hosts_per_slice
                    > self.config.max_hosts):
                return None
            out.launches.append(LaunchDecision(
                node_type=tname, hosts=cfg.hosts_per_slice, reason=reason
            ))
            slice_counts[tname] = slice_counts.get(tname, 0) + 1
            planned_hosts += cfg.hosts_per_slice
            new_caps = [cfg.host_provides()
                        for _ in range(cfg.hosts_per_slice)]
            spare.extend(new_caps)
            return new_caps

        # 1. gang demand first: whole pending placement groups -> whole
        # slices.  STRICT_PACK bundles must land in ONE ICI domain, so
        # the chosen type's slice must fit the entire bundle set.
        for gang in gangs:
            bundles = [dict(b) for b in gang.get("bundles", [])]
            if not bundles:
                continue
            if absorb_bundles(bundles):
                continue
            for tname, cfg in self.config.node_types.items():
                # real feasibility: the bundles must PACK into one
                # slice's hosts (an aggregate-capacity check admits
                # gangs no host assignment can satisfy, launching
                # slices forever)
                if not _pack(bundles, [cfg.host_provides()
                                       for _ in range(cfg.hosts_per_slice)]):
                    continue
                new_caps = try_launch(tname, f"gang:{gang.get('pg_id', '?')}")
                if new_caps is not None:
                    # consume from exactly the slice just planned for
                    # this gang — packability was verified above
                    _pack(bundles, new_caps)
                    break

        # 2. per-task demand
        for demand in demands:
            if absorb(demand):
                continue
            for tname, cfg in self.config.node_types.items():
                if _fits(demand, cfg.host_provides()):
                    new_caps = try_launch(tname, "demand")
                    if new_caps is not None:
                        _pack([demand], new_caps)
                        break

        # 3. slice-granular idle scale-down: only when no demand is
        # pending, and only slices whose EVERY host idled past the
        # timeout (single-host instances are slices of one)
        if not demands and not gangs:
            by_slice: Dict[str, List[Instance]] = {}
            for inst in im.instances(RUNNING):
                key = inst.slice_id or inst.instance_id
                by_slice.setdefault(key, []).append(inst)
            for members in by_slice.values():
                if all(
                    now - m.last_busy_at > self.config.idle_timeout_s
                    for m in members
                ):
                    out.terminations.extend(m.instance_id for m in members)
        return out


class AutoscalerV2:
    """The reconcile loop (reference: `v2/autoscaler.py:42` — each
    update(): sync state, schedule, execute)."""

    def __init__(self, provider: NodeProvider, config: AutoscalerV2Config,
                 cluster_state_fn=None):
        self.provider = provider
        self.config = config
        self.im = InstanceManager()
        self.scheduler = ResourceDemandScheduler(config)
        self._cluster_state_fn = cluster_state_fn or self._default_state

    @staticmethod
    def _default_state() -> Dict[str, Any]:
        from ray_tpu_torch.core.runtime import get_runtime

        return get_runtime().controller_call("get_autoscaler_state")

    # -- one reconcile pass -------------------------------------------
    def update(self):
        state = self._cluster_state()
        now = time.time()
        self._sync_provider(state, now)
        decision = self.scheduler.schedule(
            state.get("pending_demands", []),
            state.get("pending_gangs", []),
            self.im,
            now,
        )
        for launch in decision.launches:
            self._launch_slice(launch, now)
        self._reap_stuck_slices(now)
        self._terminate(decision.terminations)
        self.im.prune_terminated()

    def _cluster_state(self) -> Dict[str, Any]:
        return self._cluster_state_fn()

    def _sync_provider(self, state: Dict[str, Any], now: float):
        """Fold provider + controller reality into the table."""
        live_provider = set(self.provider.non_terminated_nodes())
        alive_nodes = {
            n["node_id"]: n for n in state.get("nodes", []) if n["alive"]
        }
        rt_id = getattr(self.provider, "runtime_node_id", None)
        # providers without an id mapping fold busy state via the
        # rt-launch label each booted node registered with; a busy
        # worker that carries NO launch label (e.g. a TPU-VM bootstrap
        # that predates labels) conservatively refreshes every cloud
        # instance — slower scale-down beats terminating a busy slice
        busy_launches: set = set()
        unlabeled_busy = False
        if rt_id is None:
            for n in alive_nodes.values():
                if not n.get("busy") or n.get("is_head"):
                    continue
                lid = (n.get("labels") or {}).get("rt-launch")
                if lid:
                    busy_launches.add(lid)
                else:
                    unlabeled_busy = True
        for inst in self.im.instances(REQUESTED, RUNNING, TERMINATING):
            if inst.provider_id not in live_provider:
                self.im.update_status(inst.instance_id, TERMINATED)
                continue
            if rt_id is not None and inst.runtime_node_id is None:
                try:
                    inst.runtime_node_id = rt_id(inst.provider_id)
                except KeyError:
                    pass
            node = alive_nodes.get(inst.runtime_node_id)
            if inst.status == REQUESTED and node is not None:
                self.im.update_status(inst.instance_id, RUNNING)
            elif inst.status == REQUESTED and rt_id is None:
                # provider cannot map its ids to runtime nodes (cloud
                # slices boot daemons via startup script): REAL readiness
                # (GCP state READY / GKE pod phase Running) is the
                # promotion signal — a merely-listed Pending pod/VM must
                # stay REQUESTED so it keeps absorbing its gang as
                # inbound capacity and stays reapable at the ready
                # timeout instead of triggering a duplicate slice launch
                # every reconcile tick
                if self.provider.node_is_ready(inst.provider_id):
                    self.im.update_status(inst.instance_id, RUNNING)
            if node is not None and node.get("busy"):
                inst.last_busy_at = now
            elif rt_id is None and (
                inst.launch_id in busy_launches or unlabeled_busy
            ):
                inst.last_busy_at = now
        # demand pending means nothing should look idle (matches v1)
        if state.get("pending_demands") or state.get("pending_gangs"):
            for inst in self.im.instances(RUNNING):
                inst.last_busy_at = now

    def _launch_slice(self, launch: LaunchDecision, now: float):
        """All-or-nothing: `create_slice` either yields every host or
        the partial set is rolled back (provider default already
        guarantees this for per-host providers)."""
        cfg = self.config.node_types[launch.node_type]
        slice_id = (
            f"slice-{uuid.uuid4().hex[:8]}" if launch.hosts > 1 else None
        )
        launch_id = slice_id or f"launch-{uuid.uuid4().hex[:8]}"
        node_config = {
            "num_cpus": cfg.num_cpus,
            "resources": dict(cfg.resources),
            "num_workers": cfg.num_workers,
            **cfg.provider_config,
        }
        # the launch label rides node_config -> provider -> noded
        # registration so _sync_provider can fold busy state back onto
        # these instances even without a provider id mapping
        node_config["labels"] = {
            **node_config.get("labels", {}), "rt-launch": launch_id,
        }
        if slice_id is not None:
            # every host of the slice shares one ICI-domain label so
            # STRICT_PACK placement sees them as a gang target
            node_config["labels"]["tpu-slice"] = slice_id
        try:
            pids = self.provider.create_slice(node_config, launch.hosts)
        except Exception:
            import traceback

            traceback.print_exc()
            return
        # a provider may allocate the whole slice as ONE provider node
        # (GCP multi-host TPU VM): weight each instance by the hosts it
        # represents so capacity accounting stays exact
        hosts_each = max(1, launch.hosts // max(1, len(pids)))
        for pid in pids:
            inst = Instance(
                instance_id=f"i-{uuid.uuid4().hex[:8]}",
                node_type=launch.node_type,
                status=QUEUED,
                provider_id=pid,
                slice_id=slice_id,
                launch_id=launch_id,
                hosts=hosts_each,
                requested_at=now,
                last_busy_at=now,
            )
            self.im.add(inst)
            self.im.update_status(inst.instance_id, REQUESTED)

    def _reap_stuck_slices(self, now: float):
        """A slice partially registered past the ready timeout is torn
        down WHOLE — half a slice can never serve its gang demand.
        Non-slice nodes stuck REQUESTED (a Pending pod that never
        schedules) age out the same way, singly: without this they'd
        absorb their demand as inbound capacity forever."""
        by_slice: Dict[str, List[Instance]] = {}
        for inst in self.im.instances(REQUESTED, RUNNING):
            if inst.slice_id is not None:
                by_slice.setdefault(inst.slice_id, []).append(inst)
            elif (inst.status == REQUESTED
                  and now - inst.requested_at
                  > self.config.slice_ready_timeout_s):
                self._terminate([inst.instance_id])
        for members in by_slice.values():
            waiting = [m for m in members if m.status == REQUESTED]
            if not waiting:
                continue
            oldest = min(m.requested_at for m in members)
            if now - oldest > self.config.slice_ready_timeout_s:
                self._terminate([m.instance_id for m in members])

    def _terminate(self, instance_ids: List[str]):
        for iid in instance_ids:
            inst = self.im.get(iid)
            if inst.status in (TERMINATING, TERMINATED):
                continue
            try:
                if inst.provider_id is not None:
                    self.provider.terminate_node(inst.provider_id)
                self.im.update_status(iid, TERMINATING)
            except Exception:
                import traceback

                traceback.print_exc()

    def run(self, interval_s: float = 2.0, stop_event=None):
        while stop_event is None or not stop_event.is_set():
            try:
                self.update()
            except Exception:
                import traceback

                traceback.print_exc()
            time.sleep(interval_s)
