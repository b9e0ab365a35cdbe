"""The manifest, the files it names and the contract's shape rules."""

import json

import pytest

from portbench import spec

MAN = spec.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def problems(man: dict) -> list:
    """What in the manifest breaks its naming rules or names a file that is
    not there (empty when sound)."""
    out = []
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]]
             + [w[key] for w in man["workloads"]
                for key in ("config", "traffic")]
             + [r for c in man["configs"] for r in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not spec.NAME.match(n)]
    out += [f"bad unit {m['unit']!r}"
            for m in man["end_to_end"] + man["per_layer"]
            if not spec.UNIT.match(m["unit"])]
    for c in man["configs"]:
        if not (spec.ROOT / c["file"]).is_file():
            out.append(f"missing {c['file']}")
    for w in man["workloads"]:
        for path in (spec.HERE / "traffic" / f"{w['traffic']}.json",
                     spec.HERE / "limits" / f"{w['name']}.json"):
            if not path.is_file():
                out.append(f"missing {path.relative_to(spec.ROOT)}")
    for m in man["per_layer"]:
        if not (spec.HERE / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"missing metrics/{m['name']}.py")
    return out


def test_manifest_loads_and_every_file_is_there():
    assert problems(MAN) == []


def test_entries_have_the_contracts_keys():
    assert set(MAN) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[part]:
            extra = set(entry) - KEYS[part] - {"workloads"}
            assert KEYS[part] <= set(entry) and not extra, entry["name"]
            if part in ("configs", "workloads"):
                assert "workloads" not in entry


def test_names_units_and_texts_keep_to_the_rules():
    names = [e["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for e in MAN[part]]
    assert len(names) == len(set(names))
    assert all(spec.NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
    for text in ([c["why"] for c in MAN["configs"]]
                 + [c["source"] for c in MAN["configs"]]
                 + [w["why"] for w in MAN["workloads"]]
                 + [m["layer"] for m in MAN["per_layer"]] + MAN["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_bounds_and_window_fit_the_check():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    wl = spec.workload(MAN, cell)
    assert wl["chips"] == 1
    cfg = spec.config(MAN, wl["config"])
    assert cfg["name"] == wl["config"]
    entry = [c for c in MAN["configs"] if c["name"] == wl["config"]][0]
    assert cfg["source"] == entry["source"]
    assert set(entry["reduced"]) <= set(cfg)
    traffic = spec.traffic(wl["traffic"])
    assert traffic["batch"] >= 1 and traffic["k"] == 10
    assert traffic["pool_queries"] % traffic["batch"] == 0
    ivf = cfg["index"]["build"]["method"] == "build_ann"
    assert set(spec.limits(cell)) == {"bad_hits", "score_gap"} | (
        {"missed_reachable", "partition_faults"} if ivf
        else {"missed_share"})
    assert spec.limits(cell)["bad_hits"] == 0
    assert spec.checked_config(cfg) is cfg
    assert spec.checked_traffic(traffic) is traffic


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_set_up_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in spec.metrics(MAN, cell, trace=False)]
    layers = spec.metrics(MAN, cell, trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e


def test_every_reader_loads():
    for m in MAN["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("change", [
    {"loop": "open"}, {"clients": 4}, {"filter": "1p"}, {"rate_qps": 100}])
def test_a_traffic_the_harness_does_not_implement_is_refused(change):
    traffic = spec.merged(spec.traffic("b1024"), change)
    with pytest.raises(ValueError):
        spec.checked_traffic(traffic)


@pytest.mark.parametrize("change", [
    {"index_defaults": {"nlist": 2000}}, {"data": {"skew": 1.1}},
    {"fill": {"threads": 4}}, {"collection": {"storage_dtype": "bfloat16"}},
    {"data": {"generator": "uniform"}}, {"fill": {"ids": "doc-<row>"}}])
def test_a_configuration_key_the_harness_does_not_read_is_refused(change):
    cfg = spec.merged(spec.config(MAN, "cohere768-1m-ivf"), change)
    with pytest.raises(ValueError):
        spec.checked_config(cfg)


def test_overrides_merge_nested_keys():
    base = {"a": 1, "d": {"x": 1, "y": 2}}
    assert spec.merged(base, {"d": {"y": 3}}) == {"a": 1,
                                                  "d": {"x": 1, "y": 3}}
    assert base["d"]["y"] == 2
