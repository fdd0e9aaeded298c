"""Where the tier-1 line's time goes.  Not a test: a record, run by hand.

Run the tier-1 line (ROADMAP.md) with ``-v --durations=0`` in place of
``-q`` and keep its log and its junit XML; then

    python tests/tier1_records.py path/to/log path/to/junit.xml

prints each test file's test-seconds (setup, call and teardown summed, as
the junit XML gives them) and each pytest-xdist worker's timeline: the
files it ran, in order, with their start and end in test-seconds on that
worker (the sum of the durations of the tests it finished before them;
the log's ``[gwN] ... PASSED`` lines give the order).  The file started
last shows how long the queue took to drain."""

import collections
import re
import sys
import xml.etree.ElementTree as ET


def file_seconds(xml_path):
    """{test id: seconds} and {file: (seconds, tests)} from a junit XML."""
    per_test, per_file = {}, collections.defaultdict(lambda: [0.0, 0])
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        cls = case.get("classname") or ""
        path = cls.replace(".", "/") + ".py"
        seconds = float(case.get("time") or 0.0)
        per_test[f"{path}::{case.get('name')}"] = seconds
        per_file[path][0] += seconds
        per_file[path][1] += 1
    return per_test, per_file


def timelines(log_path, per_test):
    """{worker: [(file, start, end)]} in test-seconds on each worker."""
    order = collections.defaultdict(list)
    line = re.compile(r"\[(gw\d+)\] \[\s*\d+%\] \w+ (\S+)")
    with open(log_path, errors="replace") as f:
        for text in f:
            m = line.match(text)
            if m:
                order[m.group(1)].append(m.group(2))
    out = {}
    for worker, tests in order.items():
        t, files = 0.0, []
        for test in tests:
            path = test.split("::")[0]
            if not files or files[-1][0] != path:
                files.append([path, t, t])
            t += per_test.get(test, 0.0)
            files[-1][2] = t
        out[worker] = [tuple(f) for f in files]
    return out


def main(log_path, xml_path):
    per_test, per_file = file_seconds(xml_path)
    total = sum(s for s, _ in per_file.values())
    print(f"test-seconds {total:.1f} in {len(per_file)} files")
    for path, (seconds, n) in sorted(per_file.items(),
                                     key=lambda kv: -kv[1][0]):
        print(f"  {seconds:8.1f} s {n:4d} tests  {path}")
    for worker, files in sorted(timelines(log_path, per_test).items(),
                                key=lambda kv: int(kv[0][2:])):
        print(f"{worker}: busy {files[-1][2]:.1f} s")
        for path, start, end in files:
            print(f"  {start:7.1f}-{end:7.1f}  {path}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
