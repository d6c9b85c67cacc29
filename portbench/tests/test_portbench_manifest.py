"""BENCHMARK.json against the benchmark's contract, and the harness's
sources against what it may import and read."""

import ast
import configparser
import json
import os
import re

import pytest

from .conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "tensorflow", "augmentedautoencoder_tpu"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py"))


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_top_level_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "portbench/run.py"] and manifest["paths"] == ["portbench"]
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    checks = 2 + 14 * 24
    assert checks * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(manifest)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(manifest, section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    entries = manifest[section]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text], e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e
        for k in e.get("reduced", ()):
            assert NAME.match(k)


def test_bounds(manifest):
    bounds = {m["name"]: m["bound"] for m in manifest["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in manifest["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
               for m in manifest["per_layer"])


def test_every_per_layer_metric_has_its_reader(manifest):
    for m in manifest["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        assert os.path.exists(path), path
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in ast.parse(open(path).read()).body)


def test_every_cell_reports_what_its_metrics_move(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in manifest["end_to_end"]}
    for cell in cells:
        assert cell in e2e["setup_s"] and any(cell in c for n, c in e2e.items() if n != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]] & cells, m["name"]
    roofline = [m for m in manifest["per_layer"] if m["name"].endswith("_roofline") or "mfu" in m["name"]]
    assert roofline and all(m["unit"] == "%" for m in roofline)


def test_cells_files(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    assert {w["config"] for w in manifest["workloads"]} == set(configs)
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(manifest["workloads"])
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in manifest["workloads"]) and len(four) <= max(1, len(manifest["workloads"]) // 4)
    assert len({c["file"] for c in configs.values()}) == len(configs)
    for w in manifest["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        with open(os.path.join(BENCH, "limits", w["name"] + ".json")) as fh:
            limits = json.load(fh)
        assert set(limits) == {"loss_gap", "grad_gap", "update_gap"}
        for v in limits.values():
            # above the lower reading and below the upper, with more room above the lower
            assert v["lower"] < v["limit"] < v["upper"] and v["limit"] / v["lower"] > v["upper"] / v["limit"]
    for c in configs.values():
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))


@pytest.mark.parametrize("name", ["aae_template", "aae_template_bf16"])
def test_configuration_is_the_template_but_for_its_reduced_keys(manifest, name):
    """Every key of the published template is in the file with its value
    (CODE up to white space), but the keys `reduced` names."""
    entry = {c["name"]: c for c in manifest["configs"]}[name]
    with open(os.path.join(ROOT, entry["file"])) as fh:
        config = json.load(fh)
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.optionxform = str
    cp.read(os.path.join(ROOT, "augmentedautoencoder_torch", "cfg_templates", "train_template.cfg"))
    flat = {k: v for s in config["cfg"].values() for k, v in s.items()}
    template = {k: v for s in cp.sections() for k, v in cp[s].items()}
    changed = {k for k in set(flat) | set(template)
               if "".join(str(flat.get(k)).split()) != "".join(str(template.get(k)).split())}
    assert changed == set(entry["reduced"]) == set(config["reduced"])
    assert not any(w in k.lower() for k in entry["reduced"] for w in ("size", "_dim", "_rank", "filter", "latent"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not [n for n in _imports(path) if n.split(".")[0] == "augmentedautoencoder_torch"]


def test_no_module_reads_the_old_benchmark():
    words = ("BENCH_r", "MULTICHIP_r", "BASELINE.json", "bench.py", "chip_smoke", "augmentedautoencoder_tpu/")
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not any(w in node.value for w in words), (path, node.value)
