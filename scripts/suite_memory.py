#!/usr/bin/env python3
"""Runs a command and records the resident memory of its process tree.

    python scripts/suite_memory.py --out OUT.json [--ceiling-gb G]
        [--junit RESULTS.xml] -- COMMAND [ARG ...]

Every half second it reads the RSS of each process under the command
(``/proc/<pid>/status``, ``/proc/<pid>/task/*/children``) and keeps each
process's peak, with its command line, and the tree's peak total; every 5
seconds it also notes the total and the RSS of each process above 0.2 GB. A process whose environment names an xdist worker
(``PYTEST_XDIST_WORKER``, which a worker's children inherit) is named after
it, and so is its parent. With ``--ceiling-gb`` it plays a host that ends
the largest process once the tree's total passes the ceiling: it sends
that process SIGKILL and notes the kill. With ``--junit`` it also reads the JUnit XML the
command wrote and counts each test file's passed, failed, errored and
skipped cases. It writes all of this to ``--out`` as JSON and exits with
the command's own code. It acts only on the processes the command starts.

The test suite as the tier-1 run invokes it, watched (from the repo root):

    python scripts/suite_memory.py --out /tmp/mem.json --junit /tmp/t.xml -- \\
        env PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -p xdist -n 6 \\
        --dist loadfile --junitxml=/tmp/t.xml -p no:randomly
"""
import argparse
import collections
import json
import os
import signal
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

PAGE_KB = 1024
EVERY_S, TIMELINE_S, TOP = 0.5, 5.0, 12


def rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * PAGE_KB
    except (FileNotFoundError, ProcessLookupError, PermissionError):
        pass
    return 0


def cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except (FileNotFoundError, ProcessLookupError, PermissionError):
        return ""


def environ_worker(pid: int) -> str:
    """The xdist worker a process belongs to, from its environment."""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            for item in f.read().split(b"\0"):
                if item.startswith(b"PYTEST_XDIST_WORKER="):
                    return item.split(b"=", 1)[1].decode()
    except (FileNotFoundError, ProcessLookupError, PermissionError):
        pass
    return ""


def parent(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[1])
    except (FileNotFoundError, ProcessLookupError, PermissionError, ValueError):
        return 0


def children(pid: int):
    out = []
    try:
        for tid in os.listdir(f"/proc/{pid}/task"):
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                out.extend(int(c) for c in f.read().split())
    except (FileNotFoundError, ProcessLookupError, PermissionError):
        pass
    return out


def tree(root: int):
    seen, todo = [], [root]
    while todo:
        pid = todo.pop()
        seen.append(pid)
        todo.extend(children(pid))
    return seen


def junit_counts(path: str):
    """Passed, failed, errored and skipped cases of each test file."""
    counts = collections.defaultdict(collections.Counter)
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("file") or case.get("classname", "").replace(".", "/") + ".py"
        kinds = [c.tag for c in case if c.tag in ("failure", "error", "skipped")]
        counts[name][kinds[0] if kinds else "passed"] += 1
    return {name: dict(c) for name, c in sorted(counts.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ceiling-gb", type=float, default=None)
    ap.add_argument("--junit", default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    t0 = time.monotonic()
    proc = subprocess.Popen(command)
    peak = {}                      # pid -> (peak rss, command line, seconds at the peak)
    total_peak, total_at, kills = 0, 0.0, []
    timeline, next_mark, worker_of = [], 0.0, {}
    while proc.poll() is None:
        now = time.monotonic() - t0
        sizes = {pid: rss_bytes(pid) for pid in tree(proc.pid)}
        for pid in sizes:
            if pid not in worker_of:
                name = environ_worker(pid)
                if name:          # a worker's child names its parent
                    worker_of[pid] = name
                    worker_of.setdefault(parent(pid), name)
        if now >= next_mark:
            next_mark = now + TIMELINE_S
            timeline.append({"s": round(now, 1), "total_gb": round(sum(sizes.values()) / 1e9, 3),
                             "gb": {str(pid): round(v / 1e9, 3) for pid, v in sizes.items()
                                    if v > 2e8}})
        total = sum(sizes.values())
        if total > total_peak:
            total_peak, total_at = total, now
        for pid, size in sizes.items():
            if size > peak.get(pid, (0,))[0]:
                peak[pid] = (size, peak.get(pid, (0, ""))[1] or cmdline(pid)[:200], now)
        if args.ceiling_gb is not None and total > args.ceiling_gb * 1e9:
            pid = max((p for p in sizes if p != proc.pid), key=sizes.get, default=None)
            if pid is not None:
                kills.append({"pid": pid, "rss_gb": sizes[pid] / 1e9, "total_gb": total / 1e9,
                              "seconds": now, "cmdline": cmdline(pid)[:200]})
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        time.sleep(EVERY_S)
    top = sorted(peak.items(), key=lambda kv: -kv[1][0])[:TOP]
    report = {"command": command, "rc": proc.returncode,
              "seconds": time.monotonic() - t0,
              "total_peak_gb": total_peak / 1e9, "total_peak_at_s": total_at,
              "processes_seen": len(peak),
              "top": [{"pid": pid, "worker": worker_of.get(pid, ""), "peak_gb": s / 1e9,
                       "at_s": at, "cmdline": c} for pid, (s, c, at) in top],
              "workers": {str(pid): name for pid, name in worker_of.items()},
              "timeline": timeline,
              "ceiling_gb": args.ceiling_gb, "kills": kills}
    if args.junit and os.path.exists(args.junit):
        report["junit_by_file"] = junit_counts(args.junit)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in ("rc", "seconds", "total_peak_gb", "kills")}),
          file=sys.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
