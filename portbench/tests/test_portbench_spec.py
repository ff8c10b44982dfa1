"""The harness finds every configuration, traffic mix, cell and metric by
name, and a new cell or metric is a new file plus a new entry."""
import json
import re
import shutil

import pytest

from portbench.harness.common import Reading
from portbench.harness.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_has_its_files(spec):
    bench = spec.bench
    for c in bench["configs"]:
        assert spec.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        spec.config(w["config"])
        traffic = spec.traffic(w["traffic"])
        assert (spec.dir / "harness" / f"{traffic['kind']}.py").is_file()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_benchmark_json_keeps_to_its_form(spec):
    bench = spec.bench
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for w in cells:
        reported = {m["name"] for m in spec.end_to_end(w)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(w)
    for m in bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")


@pytest.fixture
def copied(tmp_path, spec):
    root = tmp_path / "checkout"
    shutil.copytree(spec.dir, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.root / "BENCHMARK.json", root)
    return root


def test_a_new_cell_and_metric_are_files_and_entries(copied):
    bench = json.loads((copied / "BENCHMARK.json").read_text())
    traffic = json.loads((copied / "portbench/traffic/thin-series.json")
                         .read_text())
    traffic["sizes"] = [100, 200]
    (copied / "portbench/traffic/two-sizes.json").write_text(
        json.dumps(traffic))
    (copied / "portbench/metrics/slices_a_patient.serve.py").write_text(
        "def read(reading):\n"
        "    return reading.window['slices'] / reading.window['patients']\n")
    bench["workloads"].append({
        "name": "serve-two-512", "config": "ducosy-gan-released",
        "traffic": "two-sizes", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][1]["workloads"].append("serve-two-512")
    bench["per_layer"].append({
        "name": "slices_a_patient.serve", "unit": "slices",
        "better": "higher", "source": "program_counter", "layer": "engine",
        "moves": "serve_slices_per_s", "workloads": ["serve-two-512"]})
    (copied / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(copied, copied / "portbench")
    cell = spec.cell("serve-two-512")
    assert spec.traffic(cell["traffic"])["sizes"] == [100, 200]
    assert [m["name"] for m in spec.per_layer("serve-two-512")] == \
        ["slices_a_patient.serve"]
    assert "slices_a_patient.serve" not in \
        {m["name"] for m in spec.per_layer("serve-thin-512")}
    reading = Reading({}, {}, {"slices": 300, "patients": 2})
    assert spec.reader("slices_a_patient.serve")(reading) == 150
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
