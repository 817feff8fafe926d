"""Replay pytest-xdist's ``--dist load`` schedule of the tier-1 run: which
tests each worker takes, and when the last one ends.

xdist (3.8) hands each of the ``-n`` workers one first chunk of
``N // n // 4`` consecutive tests of the collection (N: the tests
collected), in the collection's order, and later tests in smaller chunks
to whichever worker runs short. It never takes a test back. So the
reference's costly tests at the head of the collection (``tests/bin``,
``data``, ``models``, ``ops``, ``parallel``) sit in the first two or three
workers' first chunks, and N alone decides where those chunks end. This
script takes the order from ``pytest --collect-only`` and each test's
seconds from a JUnit XML of a whole run (a test it lacks counts 0.05 s),
and prints each first chunk's head and tail, each worker's seconds and the
makespan; ``--sweep`` also prints the makespan for N moved by adding or
removing that many cheap tests among the port's files. Times under load
vary from run to run: compare chunkings, not seconds.

    python tools/tier1_schedule.py --junit tier1.xml --sweep -400 200 25
"""

import argparse
import heapq
import os
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def collected(marks="not slow"):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "pytest", "tests/", "-q", "-m", marks,
                          "--collect-only", "-p", "no:cacheprovider", "-p", "no:randomly"],
                         cwd=ROOT, env=env, capture_output=True, text=True).stdout
    return [line.strip() for line in out.splitlines() if "::" in line]


def junit_seconds(path):
    """{node id: seconds} from a JUnit XML."""
    seconds = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        module = [p for p in parts if not p[:1].isupper()]
        classes = [p for p in parts if p[:1].isupper()]
        node = "/".join(module) + ".py::" + "::".join(classes + [case.get("name")])
        seconds[node] = float(case.get("time", 0))
    return seconds


def schedule(seconds, workers=6):
    """(makespan, seconds a worker, the first chunk's size) of xdist's
    LoadScheduling over tests of ``seconds`` in collection order."""
    n = len(seconds)
    chunk = max(2, n // workers // 4)
    queues = [list(range(i * chunk, min(n, (i + 1) * chunk))) for i in range(workers)]
    pending = list(range(workers * chunk, n))
    load, running, events, end = [0.0] * workers, [None] * workers, [], 0.0
    for w in range(workers):
        if queues[w]:
            running[w] = queues[w].pop(0)
            heapq.heappush(events, (seconds[running[w]], w))
    while events:
        now, w = heapq.heappop(events)
        end, took = max(end, now), seconds[running[w]]
        load[w] += took
        if pending:  # xdist's check_schedule
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            if len(queues[w]) < low and not (took >= 0.1 and len(queues[w]) >= 2):
                take = high - len(queues[w])
                queues[w] += pending[:take]
                del pending[:take]
        if queues[w]:
            running[w] = queues[w].pop(0)
            heapq.heappush(events, (now + seconds[running[w]], w))
    return end, load, chunk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--junit", required=True, help="JUnit XML of a whole tier-1 run")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--sweep", type=int, nargs=3, metavar=("FROM", "TO", "STEP"),
                    help="also the makespan with N moved by FROM..TO tests")
    args = ap.parse_args(argv)
    order = collected()
    known = junit_seconds(args.junit)
    seconds = [known.get(node, 0.05) for node in order]
    end, load, chunk = schedule(seconds, args.workers)
    print(f"N={len(order)} first chunk={chunk} tests; {sum(n not in known for n in order)} "
          f"tests not in the XML")
    for w in range(args.workers):
        lo, hi = w * chunk, min(len(order), (w + 1) * chunk) - 1
        print(f"worker {w}: {load[w]:7.1f} s; first chunk {order[lo]} .. {order[hi]}")
    print(f"makespan {end:.1f} s")
    if args.sweep:
        port = [i for i, node in enumerate(order) if "/test_torch_" in node]
        cheapest = sorted(port, key=lambda i: seconds[i])
        for delta in range(args.sweep[0], args.sweep[1] + 1, args.sweep[2]):
            if delta < 0:
                drop = set(cheapest[:-delta])
                moved = [s for i, s in enumerate(seconds) if i not in drop]
            else:
                at = port[-1] + 1
                moved = seconds[:at] + [0.05] * delta + seconds[at:]
            end, load, chunk = schedule(moved, args.workers)
            print(f"N={len(moved)} ({delta:+d}) first chunk {chunk}: makespan {end:.1f} s, "
                  f"busiest worker {max(load):.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
