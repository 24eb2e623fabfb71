"""Generate tests/fast_tier.txt from a BI_SUITE_DIAG timing capture.

The fast dev tier: a `-m fast` subset that covers
every test file's primary oracle and finishes in well under 10 minutes
on the single-core dev box, while the full non-slow suite stays the
CI / order-independence gate.

Selection, from per-test call durations::

    BI_SUITE_DIAG=/tmp/suite_diag.csv pytest tests/ -q -m "not slow"
    python docs/gen_fast_tier.py /tmp/suite_diag.csv

1. Per test FILE (each file is a subsystem): the cheapest test whose
   name looks like an oracle comparison (matches/analytic/exact/...),
   plus the cheapest tests until the file has ``PER_FILE`` picks —
   skipping tests over ``CAP`` seconds unless nothing cheaper covers
   the file.
2. Fill globally with the cheapest remaining tests until the call-time
   budget (default 300 s — fixture setup and collection overhead are
   NOT in the csv, so the wall target keeps ~2x headroom).

The output is committed; conftest applies the ``fast`` marker to the
listed nodeids at collection time and warns when ids go stale.
"""

from __future__ import annotations

import csv
import re
import sys
from collections import defaultdict

ORACLE_RE = re.compile(
    r"match|analytic|exact|oracle|closed_form|agrees|recover|vs_|"
    r"quadrature|conjugate|calibrat"
)
CAP = 12.0  # per-test seconds: nothing slower unless the file needs it
PER_FILE = 2
BUDGET = 300.0  # total call-time seconds


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/suite_diag.csv"
    budget = float(sys.argv[2]) if len(sys.argv) > 2 else BUDGET
    by_file = defaultdict(list)
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) < 5:
                continue
            dt, nodeid = float(row[1]), row[4]
            by_file[nodeid.split("::")[0]].append((dt, nodeid))

    chosen, total = {}, 0.0

    def add(dt, nodeid):
        nonlocal total
        if nodeid not in chosen:
            chosen[nodeid] = dt
            total += dt

    for fname, tests in sorted(by_file.items()):
        tests.sort()
        # 1a. the cheapest oracle-looking test (capped, else cheapest)
        oracle = [t for t in tests if ORACLE_RE.search(t[1].split("::")[-1])]
        if oracle:
            capped = [t for t in oracle if t[0] <= CAP]
            add(*(capped[0] if capped else oracle[0]))
        # 1b. cheapest tests until PER_FILE picks
        for dt, nodeid in tests:
            if sum(1 for n in chosen if n.startswith(fname)) >= PER_FILE:
                break
            if dt <= CAP or len([t for t in tests if t[0] <= CAP]) == 0:
                add(dt, nodeid)

    # 2. global fill with the cheapest remaining
    rest = sorted(
        (dt, n) for tests in by_file.values() for dt, n in tests
        if n not in chosen and dt <= CAP
    )
    for dt, nodeid in rest:
        if total + dt > budget:
            break
        add(dt, nodeid)

    lines = [
        "# Generated by docs/gen_fast_tier.py from a BI_SUITE_DIAG capture.",
        "# Run `pytest tests/ -q -m fast`.  One nodeid per line; conftest",
        "# applies the marker at collection time.",
        f"# {len(chosen)} tests, ~{total:.0f} s of call time at capture.",
    ] + sorted(chosen)
    out = "tests/fast_tier.txt"
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"{out}: {len(chosen)} tests, {total:.0f} s call time, "
          f"{len(by_file)} files covered")


if __name__ == "__main__":
    main()
