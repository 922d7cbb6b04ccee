"""BENCHMARK.json against its format rules, and every file it names."""

import json

import pytest

from harness import core

MAN = core.load_manifest()


def test_manifest_has_no_errors():
    assert core.manifest_errors(MAN) == []


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", ".x", "x" * 65, "µs"])
def test_names_outside_the_allowed_characters_are_refused(name):
    man = json.loads(json.dumps(MAN))
    man["per_layer"][0]["name"] = name
    assert core.manifest_errors(man)


@pytest.mark.parametrize("unit", ["tokens per second", "x" * 17, "", "µs"])
def test_units_outside_the_allowed_characters_are_refused(unit):
    man = json.loads(json.dumps(MAN))
    man["end_to_end"][0]["unit"] = unit
    assert core.manifest_errors(man)


def test_a_per_layer_metric_in_a_cell_without_its_end_to_end_metric_is_refused():
    man = json.loads(json.dumps(MAN))
    tokens = next(m for m in man["end_to_end"] if m["name"] == "tokens_per_s")
    tokens["workloads"] = tokens["workloads"][:1]
    sgd = next(m for m in man["per_layer"] if m["moves"] == "tokens_per_s")
    sgd["workloads"] = [w["name"] for w in man["workloads"]]
    assert any("does not report" in e for e in core.manifest_errors(man))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_its_metrics_and_has_limits(cell):
    e2e = {m["name"] for m in core.end_to_end_for(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in core.per_layer_for(MAN, cell):
        assert m["moves"] in e2e
    limits = json.loads((core.BENCH / "limits" / f"{cell}.json").read_text())
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_each_configuration_has_its_system_and_reference(config):
    entry = next(c for c in MAN["configs"] if c["name"] == config)
    cfg = json.loads((core.ROOT / entry["file"]).read_text())
    assert (core.BENCH / "systems" / f"{cfg['system']}.py").is_file()
    assert (core.BENCH / "reference" / f"{config}.py").is_file()


def test_run_seconds_fits_the_full_check_with_24_cells():
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
