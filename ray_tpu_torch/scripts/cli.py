"""Cluster CLI: status / list / timeline.

Reference: `python/ray/scripts/scripts.py` (`ray status`,
`ray list ...` from `ray/util/state`) — `python -m ray_tpu_torch.scripts.cli
<cmd> --address <ready-file>`.
"""

from __future__ import annotations

import argparse
import json
import sys


def _connect(address: str):
    import ray_tpu_torch as rt

    rt.init(address=address)
    return rt


def _fmt_size(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n}B"


def render_memory_table(tables, kind=None, min_size=0) -> str:
    """Human rendering of `state.memory_summary()` grouped by node and
    process (reference: the `ray memory` grouped report)."""
    lines = []
    for node in tables:
        store = node.get("store") or {}
        lines.append(
            f"node {node['node_id'][:12]}  store "
            f"{_fmt_size(store.get('used'))}/"
            f"{_fmt_size(store.get('capacity'))}  "
            f"spilled {len(node.get('spilled') or [])}"
        )
        for proc in node.get("processes", []):
            refs = [
                r for r in proc.get("refs", [])
                if (kind is None or r["kind"] == kind)
                and (r.get("size") or 0) >= min_size
            ]
            lines.append(
                f"  {proc.get('mode')} pid={proc.get('pid')} "
                f"({len(refs)} refs, {proc.get('held_pins', 0)} pins)"
            )
            header = (f"    {'OBJECT':<18} {'KIND':<9} {'WHERE':<7} "
                      f"{'SIZE':>9}  L/S/B/C/T  LIN  CALLSITE")
            if refs:
                lines.append(header)
            for r in sorted(refs, key=lambda r: -(r.get("size") or 0)):
                counts = (f"{r['local']}/{r['submitted']}/"
                          f"{r['borrowers']}/{r['contained']}/"
                          f"{r['transit']}")
                lines.append(
                    f"    {r['object_id'][:16]:<18} {r['kind']:<9} "
                    f"{(r.get('where') or '-'):<7} "
                    f"{_fmt_size(r.get('size')):>9}  {counts:<9}  "
                    f"{'y' if r.get('lineage_pinned') else '-':<3}  "
                    f"{r.get('callsite') or '-'}"
                )
    return "\n".join(lines) if lines else "(no nodes)"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # cluster-lifecycle commands run WITHOUT a live cluster (reference:
    # `ray up/down` in autoscaler/_private/commands.py)
    if argv and argv[0] in ("up", "down", "cluster-status", "attach",
                            "exec"):
        from ray_tpu_torch.autoscaler.commands import main as cluster_main

        cmd = {"cluster-status": "status"}.get(argv[0], argv[0])
        return cluster_main([cmd] + argv[1:])
    if argv and argv[0] == "grafana-dashboard":
        # generated dashboard files, no cluster needed (reference:
        # `grafana_dashboard_factory.py`)
        gp = argparse.ArgumentParser(prog="ray_tpu_torch grafana-dashboard")
        gp.add_argument("--out", default="grafana_dashboards")
        gargs = gp.parse_args(argv[1:])
        from ray_tpu_torch.dashboard.grafana import write_dashboards

        for path in write_dashboards(gargs.out):
            print(path)
        return 0
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    p.add_argument("--address", required=True,
                   help="head ready-file path (printed at init)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status", help="cluster summary")
    lp = sub.add_parser("list", help="list cluster entities")
    lp.add_argument("what", choices=["tasks", "actors", "nodes", "jobs",
                                     "placement-groups", "workers"])
    lp.add_argument("--limit", type=int, default=100)
    ep = sub.add_parser("events", help="structured cluster event log")
    ep.add_argument("--severity", default=None)
    ep.add_argument("--limit", type=int, default=100)
    tp = sub.add_parser("timeline", help="dump chrome://tracing JSON")
    tp.add_argument("--output", default="timeline.json")
    mp = sub.add_parser(
        "memory",
        help="object-memory table: what is pinning the object store "
             "(reference: `ray memory`)",
    )
    mp.add_argument("--kind", choices=["owned", "borrowed", "pending"],
                    default=None)
    mp.add_argument("--min-size", type=int, default=0)
    mp.add_argument("--json", action="store_true", dest="as_json",
                    help="raw per-node tables instead of the rendering")
    jp = sub.add_parser("job", help="job submission")
    jsub = jp.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("entrypoint")
    js.add_argument("--wait", action="store_true")
    for name in ("status", "logs", "stop"):
        jc = jsub.add_parser(name)
        jc.add_argument("job_id")
        if name == "logs":
            jc.add_argument("-f", "--follow", action="store_true",
                            help="stream logs until the job finishes")
    jsub.add_parser("list")
    args = p.parse_args(argv)

    rt = _connect(args.address)
    from ray_tpu_torch.util import state

    try:
        if args.cmd == "status":
            print(json.dumps(state.cluster_status(), indent=2))
        elif args.cmd == "list":
            fn = {
                "tasks": lambda: state.list_tasks(limit=args.limit),
                "actors": state.list_actors,
                "nodes": state.list_nodes,
                "jobs": state.list_jobs,
                "placement-groups": state.list_placement_groups,
                "workers": state.list_workers,
            }[args.what]
            print(json.dumps(fn(), indent=2, default=str))
        elif args.cmd == "events":
            from ray_tpu_torch.core.runtime import get_runtime

            events = get_runtime().controller_call(
                "list_cluster_events",
                {"severity": args.severity, "limit": args.limit},
            )
            print(json.dumps(events, indent=2))
        elif args.cmd == "timeline":
            events = state.timeline(args.output)
            print(f"wrote {len(events)} events to {args.output}")
        elif args.cmd == "memory":
            if args.as_json:
                if args.kind or args.min_size:
                    # filters apply to JSON output too: flattened rows
                    out = state.list_objects(kind=args.kind,
                                             min_size=args.min_size)
                else:
                    out = state.memory_summary()
                print(json.dumps(out, indent=2, default=str))
            else:
                print(render_memory_table(
                    state.memory_summary(), kind=args.kind,
                    min_size=args.min_size,
                ))
        elif args.cmd == "job":
            from ray_tpu_torch import job as job_api

            if args.job_cmd == "submit":
                jid = job_api.submit_job(args.entrypoint)
                print(jid)
                if args.wait:
                    print(job_api.wait_job(jid))
            elif args.job_cmd == "status":
                print(job_api.get_job_status(args.job_id))
            elif args.job_cmd == "logs":
                if getattr(args, "follow", False):
                    for chunk in job_api.follow_job_logs(args.job_id):
                        print(chunk, end="", flush=True)
                else:
                    print(job_api.get_job_logs(args.job_id), end="")
            elif args.job_cmd == "stop":
                print(job_api.stop_job(args.job_id))
            elif args.job_cmd == "list":
                print(json.dumps(job_api.list_jobs(), indent=2))
    finally:
        rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
