"""A cell, a traffic mix and a per-layer metric added as new files (and
entries in ``BENCHMARK.json``) run without an edit to any file that is
there: the harness finds them by name."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

from perfbench.tests.helpers import ROOT, SEED

RUN = textwrap.dedent("""
    import json, sys
    sys.path[:0] = [{root!r}, {src!r}]
    from perfbench import harness, registry
    bench = registry.benchmark()
    cell = registry.cell("netflix-t2.serve-tiny", bench)
    line = harness.run_cell(cell, bench, {seed}, 0.5, True, device="cpu")
    print(json.dumps(line))
""")


def test_added_files_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    pb = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "traffic" / "serve-tiny.json").write_text(json.dumps({
        "driver": "live_stream", "requests": 12_000, "slice": 64,
        "chunk": 2048, "ring": 2, "warmup_requests": 4096}))
    (pb / "workloads" / "netflix-t2.serve-tiny.json").write_text(json.dumps({
        "config": "netflix-t2", "traffic": "serve-tiny", "chips": 1,
        "policy": {}, "limits": {"cost_rel_gap": 1e-9, "count_gap": 0,
                                 "partition_gap": 0}}))
    (pb / "metrics" / "live.settle_p50_ms.py").write_text(textwrap.dedent("""
        import numpy as np


        def read(ctx):
            s = np.asarray(ctx.counters.get("settle_s", ()))
            return None if s.size == 0 else float(np.median(s) * 1e3)
    """))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "netflix-t2.serve-tiny", "config": "netflix-t2",
        "traffic": "serve-tiny", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_req_per_s":
            m["workloads"].append("netflix-t2.serve-tiny")
    bench["per_layer"].append({
        "name": "live.settle_p50_ms", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "live engine",
        "moves": "serve_req_per_s", "workloads": ["netflix-t2.serve-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(tmp_path),
                                          src=str(ROOT / "src"), seed=SEED)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert "live.settle_p50_ms" in line["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())
