"""The manifest keeps the contract's rules, and a configuration, a mix,
a cell and a per-layer metric are added by new files and entries alone."""
import copy
import json
import shutil

import pytest

from dcom_bench import bench, harness

SMALL = {"num_layers": 3, "d_model": 128, "num_heads": 4,
         "num_kv_heads": 4, "d_ff": 256, "vocab": 512}


def test_manifest_keeps_the_rules():
    m = bench.load_manifest()
    assert bench.check_manifest(m) == []
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(w["chips"] == 1 for w in m["workloads"])
    assert 1 <= m["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  bench.load_manifest()["workloads"]])
def test_every_cell_reports_what_moves(cell):
    m = bench.load_manifest()
    e2e = {e["name"] for e in bench.e2e_of(m, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bench.per_layer_of(m, cell)
    assert layer
    for p in layer:
        assert p["moves"] in e2e
        assert bench.reader_path(p["name"]) is not None


def test_names_and_units_in_the_allowed_characters():
    bad = copy.deepcopy(bench.load_manifest())
    bad["per_layer"][0]["unit"] = "ms per step"
    bad["end_to_end"][0]["name"] = "µs/step"
    errs = bench.check_manifest(bad)
    assert any("bad unit" in e for e in errs)
    assert any("bad name" in e for e in errs)


def test_moves_must_be_reported_in_the_metric_cells():
    bad = copy.deepcopy(bench.load_manifest())
    p = next(p for p in bad["per_layer"] if p["name"] == "mfu.actdec")
    p["moves"] = "output_tok_s"
    assert any("output_tok_s is not reported" in e
               for e in bench.check_manifest(bad))


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
             "repro.core.lanczos", "repro_torch", "repro_torch.serving",
             "reprox", "jaxtyping", "numpy"]
    assert bench.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
         "repro.core.lanczos"])


def test_a_new_cell_is_only_new_files(tmp_path):
    """A throwaway configuration, mix, limits and per-layer reader, in a
    copy of this folder, run end to end on the host with no existing
    file edited."""
    base = tmp_path / "dcom_bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(bench.HERE / sub, base / sub)
    before = {p.relative_to(base): p.read_bytes()
              for p in base.rglob("*") if p.is_file()}
    conf = json.loads((bench.HERE / "configs/deepseek-7b.json").read_text())
    conf["arch"] = dict(conf["arch"], name="tiny-dense", dtype="float32",
                        **SMALL)
    (base / "configs/tiny-dense.json").write_text(json.dumps(conf))
    mix = json.loads((bench.HERE / "traffic/actdec-4k.json").read_text())
    mix.update(prompt_len=32, warmup_calls=1, trace_after=0.0,
               trace_seconds=0.2,
               policy={"layers": [1], "rank": 4, "outlier_frac": 0.03,
                       "threshold": 3.0})
    (base / "traffic/actdec-tiny.json").write_text(json.dumps(mix))
    (base / "limits/tiny-dense.actdec-tiny.json").write_text(
        json.dumps({"numbers": {"logits_rel_l2": 1e-4}}))
    (base / "metrics/calls_per_s.py").write_text(
        "def read(cell, win):\n    return win['calls'] / win['window_s']\n")
    m = copy.deepcopy(bench.load_manifest())
    m["configs"].append({"name": "tiny-dense", "source": "test",
                         "file": "dcom_bench/configs/tiny-dense.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny-dense.actdec-tiny",
                           "config": "tiny-dense", "traffic": "actdec-tiny",
                           "chips": 1, "why": "test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "actdec" in str(e.get("workloads", "")) or \
                e["name"].endswith(".actdec"):
            e["workloads"] = e["workloads"] + ["tiny-dense.actdec-tiny"]
    m["per_layer"].append({"name": "calls_per_s.actdec", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "whole step", "moves": "forward_ms",
                           "workloads": ["tiny-dense.actdec-tiny"]})
    assert bench.check_manifest(m, base) == []
    out, checks, _ = harness.measure("tiny-dense.actdec-tiny", 5, 0.5, True,
                                     device="cpu", manifest=m, base=base)
    assert out["correct"], checks
    assert out["metrics"]["calls_per_s.actdec"]["value"] > 0
    assert "mfu.actdec" in out["metrics"]
    for rel, data in before.items():
        assert (base / rel).read_bytes() == data
