"""BENCHMARK.json keeps to its contract's form, every name it gives has a
file of its own, and nothing the benchmark runs imports JAX or the JAX
package (the reference nothing of the port either)."""

import ast
import json
import os
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_lines_use_the_allowed_characters():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    metrics = b["end_to_end"] + b["per_layer"]
    for entry in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and all(NAME.match(k) for k in c["reduced"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert LINE.match(m["layer"])
    assert all(LINE.match(w) for w in b["command"])
    names = [m["name"] for m in metrics] + [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)


def test_every_name_has_its_file():
    b = bench()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(imports(path)) & {"jax", "jaxlib", "flax", "spatialrgpt_tpu"}
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        bad = {m for m in imports(path) if m.startswith("spatialrgpt_tpu")}
        assert not bad, f"{path} imports {bad}"
        assert "program" not in set(imports(path))
