"""Per-file times of a pytest run, from its ``--junitxml`` report.

    python tests/junit_times.py [before.xml] suite.xml

prints one row per test file (passed, skipped and failed cases; the sum of
its testcases' seconds), the port's files (``test_torch_*.py``) first, then
the sums of the port's and of the reference's files, and exits 1 if a port
file of the last report takes more than ``LIMIT`` seconds.  With two
reports, each row gives both.  Make a report with the suite's own command
and ``--durations=0 --junitxml=suite.xml`` (README, "Tests")."""

import collections
import sys
import xml.etree.ElementTree as ET

LIMIT = 120.0      # seconds of junit time a port file may take


def per_file(path: str) -> dict:
    """file -> Counter of "s" (seconds), "passed", "skipped", "failed"."""
    out = collections.defaultdict(collections.Counter)
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        n = next(i for i, p in enumerate(parts) if p.startswith("test_"))
        row = out["/".join(parts[:n + 1]) + ".py"]
        row["s"] += float(case.get("time", 0))
        kinds = {c.tag for c in case} & {"failure", "error", "skipped"}
        row["skipped" if "skipped" in kinds else "failed" if kinds else "passed"] += 1
    return out


def is_port(path: str) -> bool:
    return path.rsplit("/", 1)[-1].startswith("test_torch_")


def _cells(row) -> list:
    if row is None:
        return ["—", "—"]
    n = str(row["passed"]) + "".join(f"+{row[k]}{k[0]}" for k in ("skipped", "failed") if row[k])
    return [n, f"{row['s']:.1f}"]


def main(paths) -> int:
    runs = [per_file(p) for p in paths]
    last = runs[-1]
    files = sorted(set().union(*runs),
                   key=lambda f: (not is_port(f), -max(r[f]["s"] if f in r else 0 for r in runs)))
    head = ["File"] + [x for i in range(len(runs)) for x in (f"tests ({i + 1})", f"s ({i + 1})")]
    print("| " + " | ".join(head) + " |\n|" + " --- |" * len(head))
    for f in files:
        cells = [x for r in runs for x in _cells(r.get(f))]
        print(f"| `{f.removeprefix('tests/')}` | " + " | ".join(cells) + " |")
    for name, port in (("port files", True), ("reference files", False)):
        sums = [sum(v["s"] for f, v in r.items() if is_port(f) == port) for r in runs]
        print(f"| **{name}** | " + " | ".join(f" | {s:.1f}" for s in sums) + " |")
    over = sorted(f for f in last if is_port(f) and last[f]["s"] > LIMIT)
    for f in over:
        print(f"{f}: {last[f]['s']:.1f} s, over the {LIMIT:g} s limit", file=sys.stderr)
    return 1 if over else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
