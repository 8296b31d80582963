"""The benchmark is data: a configuration, a traffic mix and a per-layer
metric added as new files are found by their names, with no edit to a file
that is there."""

from __future__ import annotations

import json
import os
import re

import pytest
import torch

from conftest import make_root, tiny_config
from portbench.core import harness, readers, spec

#: what a model family module provides
FAMILY_CALLS = ("build", "attach", "loop_stats", "work", "check")


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
    for c in bench["configs"]:
        family = spec.model_family(REPO, spec.load_json(os.path.join(REPO, c["file"])))
        for call in FAMILY_CALLS:
            assert callable(getattr(family, call, None)), (c["name"], call)


def test_a_configuration_names_a_family_whose_file_exists():
    from conftest import REPO

    with pytest.raises(KeyError, match="names no"):
        spec.model_family(REPO, {k: v for k, v in tiny_config().items() if k != "family"})
    missing = os.path.join(REPO, "portbench", "families", "nonesuch.py")
    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        spec.model_family(REPO, tiny_config(family="nonesuch"))


#: a family added as a new file: the port's test-tiny backend, with a work
#: count and readings of its own
TOY = '''"""A toy family: the port's test-tiny backend, fixed work and readings."""

import sys
import types

from portbench.core import system
from portbench.core.work import DispatchWork, Gemm

READINGS = {"widest_gap": 0.0125, "structure_faults": 0, "fault_notes": [],
            "positions": 321, "requests": 7}


def build(cfg, seed, device):
    return system.build_asr(cfg, seed, device)


def attach(rec, asr):
    rec.attach_asr(asr)


def loop_stats(asr):
    return {}


def work(cfg, rec, dispatch):
    return DispatchWork(dispatch.did, 1, 1, 400, 10, 9, 10**9, [Gemm(1, 64, 64)], 1000)


def check(rec, cfg, seed, device, control=False):
    if cfg.get("toy_loads_jax"):
        sys.modules["jax"] = types.ModuleType("jax")
    return dict(READINGS)
'''


@pytest.mark.parametrize("loads_jax", [False, True], ids=["sound", "check_loads_jax"])
def test_a_new_family_is_new_files(tmp_path, loads_jax):
    """A family module, its configuration and its cell, and nothing edited:
    the harness takes the build, the work and the check from the family,
    and loads nothing of Whisper's reference or check (a fresh
    interpreter). A family whose check loads JAX gets no result: the
    harness looks again once the check has returned."""
    import subprocess
    import sys

    from conftest import REPO

    root, bench_path = make_root(tmp_path)
    with open(os.path.join(root, "portbench", "families", "toy.py"), "w") as f:
        f.write(TOY)
    with open(os.path.join(root, "portbench", "configs", "tiny.toy.json"), "w") as f:
        json.dump(tiny_config(name="tiny.toy", family="toy", toy_loads_jax=loads_jax), f)
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny.toy", "source": "https://example.org/toy",
                             "file": "portbench/configs/tiny.toy.json", "reduced": [],
                             "why": "a toy family"})
    bench["workloads"].append({"name": "toy.cell", "config": "tiny.toy",
                               "traffic": "tiny_mix", "chips": 1, "why": "a toy family"})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from portbench.core import harness\n"
            "out = harness.run_cell(%r, %r, 'toy.cell', 2**31 + 8642, 1.5, False,\n"
            "                       torch.device('cpu'), 0.0, log=lambda *_: None)\n"
            "print(json.dumps({'correct': out['correct'], 'checks': out['checks'],\n"
            "                  'loaded': sorted(sys.modules)}))" % (REPO, root, bench_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=root)
    if loads_jax:
        assert out.returncode != 0 and not out.stdout.strip()
        assert "loaded after the reference check: ['jax']" in out.stderr, out.stderr[-3000:]
        return
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["checks"] == {"widest_gap": {"value": 0.0125, "limit": 0.05},
                             "structure_faults": {"value": 0, "limit": 0},
                             "positions": {"value": 321, "limit": 20}}
    assert got["correct"] is True
    loaded = set(got["loaded"])
    assert "portbench.reference.whisper_ref" not in loaded
    assert "portbench.core.verify" not in loaded


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
