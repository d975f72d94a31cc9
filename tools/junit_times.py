"""Test time per file from a pytest junit XML, for keeping the suite
inside its time limit.

    python3 tools/junit_times.py RUN.xml
    python3 tools/junit_times.py BEFORE.xml AFTER.xml

from the repository root, on the XML that ``pytest --junitxml`` wrote
(the suite's xdist run over six workers, one file a unit of work). Sums
each test file's test time (each case's ``time``, setup and teardown
included) and prints one Markdown row a file, heaviest first, with its
number of cases; then the sums over the port's files
(``tests/test_torch_*.py``), over the reference's and over all, and that
total over six workers, the wall time the run cannot beat. Given two
files, it prints both columns side by side, keyed by file. Nothing is
run: it reads the XML only.
"""
import collections
import sys
import xml.etree.ElementTree as ET

WORKERS = 6


def per_file(path):
    """{file stem: [seconds, cases]} of one junit XML."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for case in ET.parse(path).getroot().iter("testcase"):
        stem = case.get("classname", "?").split(".")[-1]
        out[stem][0] += float(case.get("time") or 0.0)
        out[stem][1] += 1
    return dict(out)


def sums(files):
    port = sum(t for f, (t, _) in files.items() if f.startswith("test_torch"))
    total = sum(t for t, _ in files.values())
    return {"port": port, "reference": total - port, "all": total,
            f"all / {WORKERS}": total / WORKERS}


def main(paths) -> int:
    runs = [per_file(p) for p in paths]
    names = sorted(set().union(*runs), key=lambda f: -runs[-1].get(
        f, [0.0])[0])
    head = " | ".join(f"{p} s | cases" for p in paths)
    print(f"| file | {head} |")
    print("| --- |" + " --- | --- |" * len(paths))
    for f in names:
        cells = " | ".join(
            f"{r[f][0]:.1f} | {r[f][1]}" if f in r else "- | -" for r in runs)
        print(f"| {f} | {cells} |")
    for key in sums(runs[0]):
        cells = " | ".join(f"{sums(r)[key]:.1f} |" for r in runs)
        print(f"| **{key}** | {cells} |")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
