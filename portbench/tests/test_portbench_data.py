"""The benchmark is data: a configuration, a traffic mix and a per-layer
metric added as new files are found by their names, with no edit to a file
that is there."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import make_root, tiny_config
from portbench.core import harness, readers, spec


def _add_cell(root, bench_path, cfg_name, mix_name, metric_name):
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": cfg_name, "source": "https://example.org/x",
                             "file": f"portbench/configs/{cfg_name}.json", "reduced": [],
                             "why": "added"})
    bench["workloads"].append({"name": "added.cell", "config": cfg_name, "traffic": mix_name,
                               "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": metric_name, "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "serving",
                               "moves": "audio_throughput", "workloads": ["added.cell"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)


def test_new_config_mix_and_metric_are_taken_as_data(tmp_path):
    root, bench_path = make_root(tmp_path)
    cfg = tiny_config(name="tiny2.int8-all", caps={"max_new_tokens": 48,
                                                   "max_total_tokens": 48,
                                                   "max_tokens_per_second": 3.0})
    with open(os.path.join(root, "portbench", "configs", "tiny2.int8-all.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "portbench", "traffic", "tiny_mix.json")) as f:
        mix = json.load(f)
    mix["utterance_median_s"] = 3.0
    with open(os.path.join(root, "portbench", "traffic", "short_utterances.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "portbench", "metrics", "serving.streams_seen.tput.py"),
              "w") as f:
        f.write("def read(run):\n    return float(len({r.stream for r in run.rec.reqs}))\n")
    _add_cell(root, bench_path, "tiny2.int8-all", "short_utterances", "serving.streams_seen.tput")
    cell = spec.load_cell(bench_path, "added.cell", root)
    assert cell.config["caps"]["max_tokens_per_second"] == 3.0
    assert cell.traffic["utterance_median_s"] == 3.0
    assert "serving.streams_seen.tput" in [m["name"] for m in cell.per_layer]
    other = spec.load_cell(bench_path, "tiny.cell", root)
    assert "serving.streams_seen.tput" not in [m["name"] for m in other.per_layer]
    out = harness.run_cell(root, bench_path, "added.cell", 77, 1.5, False,
                           torch.device("cpu"), 0.0, log=lambda *_: None)
    assert out["correct"], out["checks"]
    # the new reader, found by its name, reads the run's notes
    reader = spec.metric_reader(root, "serving.streams_seen.tput")

    class Rec:
        reqs = [type("R", (), {"stream": s})() for s in (0, 1, 1)]

    assert reader(readers.RunData(None, cfg, Rec(), None, [], {})) == 2.0


def test_every_metric_of_the_benchmark_has_its_reader_and_every_cell_its_files():
    from conftest import REPO

    path = os.path.join(REPO, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(REPO, m["name"])), m["name"]
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    for w in bench["workloads"]:
        cell = spec.load_cell(path, w["name"], REPO)
        assert spec.traffic_kind(REPO, cell.traffic["kind"]).run
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["v3-int8.one", "turbo-int8.one"])
@pytest.mark.parametrize("control", [0, 1])
def test_a_cell_runs_on_the_card(workload, control):
    """One short run of a cell through ``run.py`` (needs a card): correct,
    and with the int4 control in the program's place not correct."""
    import subprocess
    import sys

    from conftest import REPO

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 4711), "--seconds", "10", "--trace", "0",
                          "--control", str(control)], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is (control == 0), line["checks"]
