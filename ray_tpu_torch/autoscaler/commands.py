"""Cluster launcher: `rt up / down / status <cluster.yaml>`.

Reference: `python/ray/autoscaler/_private/commands.py` (`ray up/down`)
+ the cluster YAML schema (`autoscaler/ray-schema.json`), collapsed to
the fields this framework's two providers need:

```yaml
cluster_name: my-gpu-cluster
provider:
  type: gcp_gpu            # or: local
  project: my-project
  zone: us-central1-a
  machine_type: a3-highgpu-1g  # its cards come with the type
  # accelerator: nvidia-tesla-t4:2  # guest cards for an n1-* type
  # source_image: an image with the NVIDIA driver (default: a Deep
  #   Learning VM family, gcp.DEFAULT_SOURCE_IMAGE)
head:
  controller_host: 10.0.0.2  # head VM IP; REQUIRED to create workers
  controller_port: 7777      # where workers join
min_workers: 1
max_workers: 4
worker:
  machine_type: a3-highgpu-8g
  num_workers: 8           # worker processes per node
```

`up` creates the head node then min_workers workers whose startup
script joins the head; `down` terminates every node carrying the
cluster label.  All API traffic goes through the provider's injectable
transport, so the whole flow dry-runs against a mock (tests) and the
CLI offers --dry-run for real configs.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.gcp import (
    _LIVE_STATES,
    DEFAULT_SOURCE_IMAGE,
    GcpGpuNodeProvider,
    chips_for_accelerator_type,
    head_startup_script,
    worker_startup_script,
)


def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    for key in ("cluster_name", "provider"):
        if key not in cfg:
            raise ValueError(f"cluster config missing required key {key!r}")
    ptype = cfg["provider"].get("type")
    if ptype not in ("gcp_gpu", "local"):
        raise ValueError(f"unknown provider type {ptype!r}")
    if ptype == "gcp_gpu":
        for key in ("project", "zone"):
            if key not in cfg["provider"]:
                raise ValueError(f"gcp_gpu provider needs {key!r}")
    return cfg


class _DryRunTransport:
    """Records the API calls `up/down` would make."""

    def __init__(self):
        self.calls: List[tuple] = []
        self.nodes: Dict[str, dict] = {}

    def __call__(self, method: str, url: str, body: Optional[dict]) -> dict:
        self.calls.append((method, url, body))
        if method == "POST" and url.endswith("/bulkInsert"):
            for node_id in body["perInstanceProperties"]:
                self.nodes[node_id] = {
                    "name": node_id,
                    "status": "RUNNING",
                    **body["instanceProperties"],
                }
        elif method == "POST":
            self.nodes[body["name"]] = {"status": "RUNNING", **body}
        if method == "DELETE":
            self.nodes.pop(url.rsplit("/", 1)[-1], None)
        if method == "GET":
            return {"items": list(self.nodes.values())}
        return {}


def _machine(cfg: Dict[str, Any], role: str) -> Dict[str, Any]:
    """A role's (`head` / `worker`) machine type and accelerator spec,
    each defaulting to the provider's."""
    p, r = cfg["provider"], cfg.get(role, {})
    return {
        "machine_type": r.get("machine_type",
                              p.get("machine_type", "a3-highgpu-1g")),
        "accelerator": r.get("accelerator", p.get("accelerator")),
    }


def _num_gpus(machine: Dict[str, Any]) -> int:
    return chips_for_accelerator_type(machine["machine_type"],
                                      machine["accelerator"])


def _provider_for(cfg: Dict[str, Any], transport=None) -> GcpGpuNodeProvider:
    p = cfg["provider"]
    head = cfg.get("head", {})
    controller_host = head.get("controller_host", "HEAD_IP")
    controller_port = int(head.get("controller_port", 7777))
    script = worker_startup_script(
        controller_host, controller_port,
        num_workers=int(cfg.get("worker", {}).get("num_workers", 0)),
        num_gpus=_num_gpus(_machine(cfg, "worker")),
    )
    return GcpGpuNodeProvider(
        project=p["project"],
        zone=p["zone"],
        cluster_name=cfg["cluster_name"],
        machine_type=p.get("machine_type", "a3-highgpu-1g"),
        accelerator=p.get("accelerator"),
        source_image=p.get("source_image", DEFAULT_SOURCE_IMAGE),
        startup_script=script,
        network=p.get("network"),
        transport=transport,
    )


def up(cfg: Dict[str, Any], *, transport=None, _print=print) -> Dict[str, Any]:
    """Create head + min_workers workers.  Returns a summary dict."""
    provider = _provider_for(cfg, transport)
    # one list call: ids carry no type information, labels do
    nodes = provider._list()
    live = {
        n["name"]: n.get("labels", {}).get("rt-node-type", "worker")
        for n in nodes
        if n.get("status") in _LIVE_STATES
    }
    created: Dict[str, List[str]] = {"head": [], "worker": []}
    have_head = "head" in live.values()
    n_workers = int(cfg.get("min_workers", 0))
    if n_workers and not cfg.get("head", {}).get("controller_host"):
        raise ValueError(
            "head.controller_host is required to create workers: their "
            "startup script must point at the head's controller.  Run "
            "`up` with min_workers: 0 first, read the head VM's IP, set "
            "head.controller_host, then `up` again (or let the in-"
            "cluster autoscaler add workers)."
        )
    if not have_head:
        machine = _machine(cfg, "head")
        created["head"] = provider.create_node(
            {"node_type": "head",
             **machine,
             # the head bootstraps its own daemon (controller + noded
             # bound on all interfaces) instead of the worker script
             "startup_script": head_startup_script(
                 int(cfg.get("head", {}).get("controller_port", 7777)),
                 num_workers=int(cfg.get("head", {}).get(
                     "num_workers", 0)),
                 num_gpus=_num_gpus(machine),
             )},
            1,
        )
        _print(f"created head node {created['head'][0]}")
    existing_workers = sum(1 for t in live.values() if t != "head")
    to_create = max(0, n_workers - existing_workers)
    if to_create:
        created["worker"] = provider.create_node(
            {"node_type": "worker", **_machine(cfg, "worker")},
            to_create,
        )
        _print(f"created {to_create} worker node(s)")
    return {"created": created, "live_before": sorted(live)}


def down(cfg: Dict[str, Any], *, transport=None, _print=print) -> List[str]:
    """Terminate every node of the cluster; returns their ids."""
    provider = _provider_for(cfg, transport)
    ids = provider.non_terminated_nodes()
    for pid in ids:
        provider.terminate_node(pid)
        _print(f"terminated {pid}")
    return ids


def status(cfg: Dict[str, Any], *, transport=None) -> List[Dict[str, Any]]:
    return _provider_for(cfg, transport).list_cluster_nodes()


# ----------------------------------------------------------------------
# attach / exec (reference: `ray attach` / `ray exec`,
# `autoscaler/_private/commands.py` + `command_runner.py`)
# ----------------------------------------------------------------------
def _head_runner(cfg: Dict[str, Any], *, transport=None,
                 runner_factory=None):
    """CommandRunner for the cluster's head node.  `runner_factory`
    (ip -> CommandRunner) is the injection seam tests use."""
    provider = _provider_for(cfg, transport)
    head_id = None
    for n in provider._list():
        if n.get("labels", {}).get("rt-node-type") == "head" and \
                n.get("status") in _LIVE_STATES:
            head_id = n["name"]
            break
    if head_id is None:
        raise RuntimeError(
            f"cluster {cfg['cluster_name']!r} has no live head node; "
            "run `rt up` first"
        )
    ip = provider.node_ip(head_id)
    if ip is None:
        raise RuntimeError(f"head node {head_id} reports no IP yet")
    if runner_factory is not None:
        return runner_factory(ip)
    from ray_tpu_torch.autoscaler.command_runner import runner_for

    return runner_for(cfg, ip)


def exec_on_head(cfg: Dict[str, Any], command: str, *, transport=None,
                 runner_factory=None, timeout: Optional[float] = None):
    """Run one shell command on the head node; returns (rc, output)
    (reference: `ray exec`)."""
    runner = _head_runner(cfg, transport=transport,
                          runner_factory=runner_factory)
    return runner.run(command, timeout=timeout)


def attach(cfg: Dict[str, Any], *, transport=None, runner_factory=None,
           _print=print) -> int:
    """Interactive shell on the head node (reference: `ray attach`).
    Prints the equivalent ssh command first so the session is
    reproducible without the CLI."""
    runner = _head_runner(cfg, transport=transport,
                          runner_factory=runner_factory)
    _print("attaching: " + " ".join(runner.remote_shell_command("bash")))
    return runner.run_interactive("bash")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="rt-cluster", description=__doc__)
    p.add_argument("command",
                   choices=["up", "down", "status", "exec", "attach"])
    p.add_argument("config", help="cluster YAML path")
    p.add_argument("--dry-run", action="store_true",
                   help="print the API calls instead of making them")
    p.add_argument("--cmd", default=None,
                   help="shell command for `exec`")
    args = p.parse_args(argv)
    cfg = load_cluster_config(args.config)
    transport = _DryRunTransport() if args.dry_run else None
    if args.command in ("attach", "exec") and args.dry_run:
        # these commands run over ssh, not the provider API — there is
        # no call list to preview
        p.error(f"--dry-run is not supported with {args.command}")
    if args.command == "attach":
        return attach(cfg, transport=transport)
    if args.command == "exec":
        if not args.cmd:
            p.error("exec requires --cmd")
        rc, out = exec_on_head(cfg, args.cmd, transport=transport)
        print(out, end="")
        return rc
    fn = {"up": up, "down": down, "status": status}[args.command]
    out = fn(cfg, transport=transport)
    if args.dry_run:
        for method, url, _body in transport.calls:
            print(f"DRY-RUN {method} {url}")
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    main()
