"""A cell, a configuration and a per-layer metric added as data and files
alone, with no edit to a file of the harness: the run finds them by name.
The example cell is written into a temporary copy, not committed."""
import json
import os

from benchmark.run import run_cell
from benchmark.tests.tiny import make_tiny

READER = '''"""links_traced: the links of the traced slice (an example reader)."""


def read(ctx):
    return ctx.counts.get("links")
'''


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root, bench = make_tiny(str(tmp_path))
    with open(os.path.join(bench, "configs", "usair_pos.json")) as f:
        config = json.load(f)
    config["name"] = "ring_pos"
    config["graph"] = {"generator": "chung_lu", "seed": 3, "n": 60, "n_undirected": 240,
                       "exponent": 0.3}
    with open(os.path.join(bench, "configs", "ring_pos.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "workloads", "prep_stream_32.json"), "w") as f:
        json.dump({"kind": "prep", "source": "stream", "chunk_links": 32, "positive_share": 0.5,
                   "check_per_unit": 2, "check_max": 16, "trace_units": 2}, f)
    with open(os.path.join(bench, "limits", "ring_pos.prep.json"), "w") as f:
        json.dump({"ops_gap": 1e-5}, f)
    with open(os.path.join(bench, "readers", "links_traced.py"), "w") as f:
        f.write(READER)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "ring_pos", "source": "https://example.org", "reduced": [],
                         "file": "benchmark/configs/ring_pos.json", "why": "example"})
    b["workloads"].append({"name": "ring_pos.prep", "config": "ring_pos",
                           "traffic": "prep_stream_32", "chips": 1, "why": "example"})
    for m in b["end_to_end"]:
        if m["name"] == "prep_links_per_s":
            m["workloads"].append("ring_pos.prep")
    b["per_layer"].append({"name": "links_traced", "unit": "links", "better": "higher",
                           "source": "program_counter", "layer": "pos operators",
                           "moves": "prep_links_per_s", "workloads": ["ring_pos.prep"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)

    result, _ = run_cell("ring_pos.prep", 9, 0.3, False, root=root, bench_dir=bench, device="cpu")
    assert result["correct"] and set(result["metrics"]) == {"prep_links_per_s", "setup_s"}
    result, _ = run_cell("ring_pos.prep", 9, 0.3, True, root=root, bench_dir=bench, device="cpu")
    assert result["correct"] and result["metrics"]["links_traced"]["value"] == 64
