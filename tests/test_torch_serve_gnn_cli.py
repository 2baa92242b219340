"""The port's GNN serving CLI (``repro_torch.launch.serve_gnn.main``) with
JAX's ``--trace OUT.json`` and ``--drift`` (``repro/launch/serve_gnn.py``),
on the CPU: a GAT session on ``tiny`` prints JAX's trace line (event
count, path, span coverage), the drift report's header and one line per
row (``DRIFTED`` where the row drifted) and the ``serve.batch_seconds``
summary; the file it writes reads back as Chrome-trace JSON holding the
session's serving spans.
"""
import json
import re

import pytest

from repro_torch.launch import serve_gnn
from repro_torch.obs import clear_events, clear_trace, drift_report


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    import contextlib
    import io

    clear_trace()
    clear_events()
    path = str(tmp_path_factory.mktemp("serve_gnn") / "t.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_gnn.main(["--app", "gat", "--dataset", "tiny", "--device",
                        "cpu", "--clients", "2", "--requests", "10",
                        "--trace", path, "--drift"])
    return path, out.getvalue().splitlines(), drift_report()


def test_trace_line_and_file(session):
    path, lines, _ = session
    got = [ln for ln in lines if ln.startswith("[serve_gnn] trace:")]
    assert len(got) == 1, lines
    m = re.fullmatch(r"\[serve_gnn\] trace: (\d+) events → (.+) \(span "
                     r"coverage (\d+\.\d)%\)", got[0])
    assert m and m.group(2) == path, got[0]
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert len(events) == int(m.group(1)) > 0
    assert doc["displayTimeUnit"] == "ms"
    for e in events:
        assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e), e
        assert e["ph"] == "X" and e["dur"] >= 0
    assert any(e["name"].startswith("serve.") for e in events)
    assert 0.0 < float(m.group(3)) <= 100.0


def test_drift_report_lines(session):
    _, lines, rows = session
    head = [i for i, ln in enumerate(lines)
            if ln.startswith("[serve_gnn] drift report (")]
    assert len(head) == 1, lines
    n = int(re.fullmatch(r"\[serve_gnn\] drift report \((\d+) rows\):",
                         lines[head[0]]).group(1))
    assert n == len(rows) > 0
    body = lines[head[0] + 1:head[0] + 1 + n]
    row = re.compile(r"  (\S+)\s+(\S+)\s+pred=\S+ meas=\d+\.\d{3}ms "
                     r"ratio=\d+\.\d\d(  DRIFTED)?")
    for ln, r in zip(body, rows):
        m = row.fullmatch(ln)
        assert m, ln
        assert (m.group(1), m.group(2)) == (r["op"], r["chosen"])
        assert bool(m.group(3)) == r["drifted"]
    batch = [ln for ln in lines
             if ln.startswith("[serve_gnn] serve.batch_seconds: ")]
    assert len(batch) == 1 and re.fullmatch(
        r"\[serve_gnn\] serve\.batch_seconds: n=\d+ mean=\d+\.\d{3}ms",
        batch[0]), batch
