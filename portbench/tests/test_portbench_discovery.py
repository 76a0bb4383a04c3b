"""A configuration, a traffic mix, a cell's limits and a per-layer metric
added as new files are found by name, with no existing file edited."""

import hashlib
import json
import shutil

from portbench import common


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "portbench"
    shutil.copytree(common.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(here)
    cfg = json.loads((here / "configs" / "beam_s_dpivae.json").read_text())
    cfg["name"] = "beam_s_wide"
    (here / "configs" / "beam_s_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "train_jobs.json").read_text())
    mix["n_iter"] = 20000
    (here / "traffic" / "train_jobs_long.json").write_text(json.dumps(mix))
    (here / "limits" / "beam_wide_long.json").write_text('{"loss0_gap": 1e-4}')
    (here / "metrics" / "jobs_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec['spans']))\n")
    monkeypatch.setattr(common, "HERE", here)

    bench = common.load_benchmark()
    bench["workloads"].append({"name": "beam_wide_long",
                               "config": "beam_s_wide",
                               "traffic": "train_jobs_long", "chips": 1})
    work, got_cfg, got_mix, limits = common.cell(bench, "beam_wide_long")
    assert got_cfg["name"] == "beam_s_wide" and got_mix["n_iter"] == 20000
    assert limits == {"loss0_gap": 1e-4}
    assert common.driver(got_mix["kind"]).__name__.endswith("train_jobs")
    reader = common.metric_reader("jobs_in_window")
    assert reader({"spans": [1, 2, 3]}) == 3.0
    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before
