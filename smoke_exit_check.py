"""Run `chip_smoke.py` as a harness does, with its output on pipes, and
report what outlives it.

    python3 smoke_exit_check.py [--out-dir DIR] [--name NAME] [--timeout S]

Run from a checkout's root on the machine with the card.  The script's
standard output and error go to `DIR/NAME.log` and `DIR/NAME.err` (DIR
`smoke_exit`, NAME `smoke` unless given); the
table of every process on the machine (`ps`) before the run, at its exit,
and 3 and 15 s after goes to `DIR/NAME_ps.txt`.  The script runs with
`SMOKE_EXIT_CHECK` set to a token of this run, which every process it
starts inherits.  Prints one JSON object: the exit code, the seconds the
script took, the seconds from its last output to its exit, which of its
pipes reached their end, and the processes carrying the token at the
exit and 15 s after.  Exits 1 if one is left at 15 s, else with the
script's code."""
import argparse
import json
import os
import subprocess
import sys
import threading
import time


def processes():
    """(pid -> its `ps` row, for every process on the machine; the
    table's header)."""
    out = subprocess.run(["ps", "-eo", "pid,ppid,pgid,sid,etimes,stat,args"],
                         capture_output=True, text=True, check=True).stdout
    rows = out.splitlines()
    return {int(r.split()[0]): r for r in rows[1:]}, rows[0]


def carrying(token: bytes) -> list:
    """The pids whose environment holds `token`."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                if token in f.read().split(b"\0"):
                    found.append(int(name))
        except OSError:  # gone, or not ours to read
            continue
    return sorted(found)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="smoke_exit")
    ap.add_argument("--name", default="smoke")
    ap.add_argument("--timeout", type=float, default=1200.0)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.join(args.out_dir, args.name)

    before, header = processes()
    t0 = time.time()
    token = f"{os.getpid()}-{time.time_ns()}"
    tag = f"SMOKE_EXIT_CHECK={token}".encode()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={**os.environ, "SMOKE_EXIT_CHECK": token})
    ended, last = {}, {}

    def pump(stream, path, key):
        with open(path, "wb") as f:
            for chunk in iter(lambda: stream.read1(65536), b""):
                f.write(chunk)
                f.flush()
                last[key] = time.time()
        ended[key] = time.time()

    pumps = [threading.Thread(target=pump, args=(proc.stdout, base + ".log",
                                                 "out")),
             threading.Thread(target=pump, args=(proc.stderr, base + ".err",
                                                 "err"))]
    for t in pumps:
        t.start()
    try:
        rc = proc.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    t_exit = time.time()
    at_exit = carrying(tag)
    snaps = [("at exit", processes()[0])]
    time.sleep(3.0)
    snaps.append(("exit + 3 s", processes()[0]))
    for t in pumps:
        t.join(timeout=12.0)
    time.sleep(max(0.0, t_exit + 15.0 - time.time()))
    left = carrying(tag)
    snaps.append(("exit + 15 s", processes()[0]))
    with open(base + "_ps.txt", "w") as f:
        for label, rows in [("before", before), *snaps]:
            f.write(f"--- {label}\n{header}\n" + "\n".join(rows.values())
                    + "\n")
    print(json.dumps({
        "rc": rc, "seconds": t_exit - t0,
        "last_output_before_exit_s": {k: t_exit - v for k, v in last.items()},
        "pipes_ended": sorted(ended), "alive_at_exit": at_exit,
        "left": left}), flush=True)
    return 1 if left else rc


if __name__ == "__main__":
    sys.exit(main())
