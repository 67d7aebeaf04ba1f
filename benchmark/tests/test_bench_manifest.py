"""BENCHMARK.json against the contract, each configuration, mix and metric
found by name, and a configuration, a mix and a metric added as files
alone and run."""
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import readers, run, traffic

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return run.manifest()


def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert len(json.dumps(man)) < 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time(man):
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys(man):
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in man[group]}) == len(man[group])
    metric_names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_bounds_and_sources(man):
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["name"].split(".")[0].endswith(("_roofline", "mfu"))


def test_every_cell_finds_its_configuration_mix_and_metrics_by_name(man):
    configs = {c["name"]: c for c in man["configs"]}
    for w in man["workloads"]:
        cfg = run.load_config(w["config"])
        assert cfg["name"] == w["config"]
        assert ROOT / configs[w["config"]]["file"] == run.BENCH / "configs" / f"{w['config']}.json"
        assert set(cfg["reduced"]) == set(configs[w["config"]]["reduced"])
        assert traffic.load(w["traffic"])["kind"] in ("closed", "open")
        e2e = [m for m in man["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        layer = [m for m in man["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:
            moves = next(e for e in man["end_to_end"] if e["name"] == m["moves"])
            assert w["name"] in moves.get("workloads", [w["name"]])
    for m in man["per_layer"]:
        assert callable(readers.load(m["name"]))
    used = {w["config"] for w in man["workloads"]}
    assert used == set(configs)


def test_every_cell_has_limits_for_what_it_compares(man):
    from benchmark import check

    for w in man["workloads"]:
        kind = traffic.load(w["traffic"])["kind"]
        want = {"closed": {"enc_gap", "enc_diff"}, "open": {"score_gap", "rank_gap"}}[kind]
        assert check.limits(w["name"]) and set(check.limits(w["name"])) <= want


DUMMY_CONFIG = "tiny-vgg"
DUMMY_METRIC = '''from benchmark.readers import Context


def read(ctx: Context):
    return float(ctx.items) if ctx.kind == "closed" else None
'''


def test_a_configuration_a_mix_and_a_metric_added_as_files_alone_run(tmp_path):
    """A copy of the benchmark gains a configuration, a mix and a metric by
    new files and manifest entries only, and a traced run reports the
    metric (on the CPU, where the program takes its plain versions)."""
    from benchmark.tests.conftest import GALLERY, tiny_vgg

    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}
    cfg = tiny_vgg()
    cfg["name"] = DUMMY_CONFIG
    (copy / "benchmark/configs" / f"{DUMMY_CONFIG}.json").write_text(json.dumps(cfg))
    (copy / "benchmark/traffic/tiny-gallery.json").write_text(json.dumps(GALLERY))
    (copy / "benchmark/metrics/items.tiny.py").write_text(DUMMY_METRIC)
    man = run.manifest()
    man["configs"].append({"name": DUMMY_CONFIG, "source": "https://arxiv.org/abs/1409.1556",
                           "file": f"benchmark/configs/{DUMMY_CONFIG}.json", "reduced": [],
                           "why": "a tiny copy for the test"})
    man["workloads"].append({"name": "tiny.gallery", "config": DUMMY_CONFIG,
                             "traffic": "tiny-gallery", "chips": 1, "why": "the test"})
    man["per_layer"].append({"name": "items.tiny", "unit": "img", "better": "higher",
                             "source": "host_clock", "layer": "API", "moves": "encode_img_per_s",
                             "workloads": ["tiny.gallery"]})
    for m in man["end_to_end"]:
        if m["name"] == "encode_img_per_s":
            m["workloads"].append("tiny.gallery")
    (copy / "BENCHMARK.json").write_text(json.dumps(man))
    for p, data in before.items():
        assert p.read_bytes() == data  # no file that was there changed
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "import torch; torch.set_num_threads(2);"
            "from benchmark import run; assert run.ROOT == __import__('pathlib').Path(sys.argv[1]);"
            "r = run.run('tiny.gallery', 7, 0.5, True, device='cpu');"
            "print(json.dumps(r['metrics']))")
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", code, str(copy), str(ROOT)], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["items.tiny"]["value"] > 0 and metrics["items.tiny"]["unit"] == "img"
