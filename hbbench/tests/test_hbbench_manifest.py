"""BENCHMARK.json against the contract's naming rules, every piece of every
cell found by name, a new workload taken without an edit, and no JAX."""
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from hbbench.lib import cell as cell_lib

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cell_lib.manifest()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hbbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("config", "traffic"):
                if key in e:
                    assert NAME.match(e[key])
            for key in e.get("reduced", ()):
                assert NAME.match(key)
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_rules():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_found_by_name(name):
    cell = cell_lib.find(name)
    assert cell.model.make_weights and cell.model.program
    assert cell.reference.forward
    assert cell.loop.window
    for m in cell.end_to_end + cell.per_layer:
        assert cell_lib.metric_module(m["name"]).read
    conf = next(c for c in BENCH["configs"] if c["name"] == cell.config_name)
    assert (ROOT / conf["file"]).is_file()
    assert conf["file"].startswith("hbbench/")


def test_a_new_workload_file_is_taken_without_an_edit(tmp_path, monkeypatch):
    """A copy of the benchmark with one more traffic file and manifest
    entry: the cell is found, and no file of the copy differs from the
    original but the new one."""
    copy = tmp_path / "hbbench"
    shutil.copytree(ROOT / "hbbench", copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((copy / "workloads" / "r18-range-c8.json").read_text())
    mix["clients"] = 4
    (copy / "workloads" / "r18-range-c4.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "r18-range-c4", "config": "resnet18-cifar10",
                               "traffic": "r18-range-c4", "chips": 1, "why": "x"})
    monkeypatch.setattr(cell_lib, "BENCH", copy)
    cell = cell_lib.find("r18-range-c4", bench)
    assert cell.workload["clients"] == 4 and cell.plan["groups"]
    for f in (ROOT / "hbbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (copy / f.relative_to(ROOT / "hbbench")).read_bytes() == f.read_bytes()


_IMPORT_ALL = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from hbbench.lib import cell, harness, program, trace
import repro_torch.api, repro_torch.models.resnet, repro_torch.models.lm
for c in cell.manifest()["workloads"]:
    x = cell.find(c["name"])
    x.model, x.reference, x.loop
    [cell.metric_module(m["name"]) for m in x.end_to_end + x.per_layer]
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

_IMPORT_REFERENCES = """
import sys
sys.path[:0] = [{root!r}]
from hbbench.lib import cell
for c in cell.manifest()["configs"]:
    cell.reference_module(c["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(src=str(ROOT / "src"),
                                                            root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    found = _top_level(_IMPORT_ALL)
    assert "repro_torch" in found
    assert not found & {"jax", "jaxlib", "flax", "repro"}


def test_references_import_nothing_of_the_program():
    found = _top_level(_IMPORT_REFERENCES)
    assert not found & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
    for conf in BENCH["configs"]:
        src = (cell_lib.config_dir(conf["name"]) / "reference.py").read_text()
        assert not re.search(r"^\s*(import|from)\s+(repro|repro_torch|jax)\b", src, re.M)


def test_nothing_reads_the_jax_benchmarks():
    for f in (ROOT / "hbbench").rglob("*.py"):
        if "tests" in f.relative_to(ROOT / "hbbench").parts:
            continue
        text = f.read_text()
        assert "BENCH_relu" not in text and "benchmarks/" not in text, f
