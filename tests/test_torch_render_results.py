"""ivfhnsw_tpu_torch/tools/render_results.py: the README's port table is
what the tool renders from the committed RESULTS_TORCH_LATEST.json; a stale
number fails --check; --snapshot merges bench records stage by stage with
each record's card line and time; a stage no record measured renders "not
measured"; no JAX RESULTS_*.json and no .bench_cache/ path is read.
Imports no jax.
"""

import builtins
import json
import os
import shutil
import subprocess
import sys

import pytest

from ivfhnsw_tpu_torch.tools import render_results as rr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _copies(tmp_path):
    readme, results = tmp_path / "README.md", tmp_path / "snap.json"
    shutil.copy(rr.README, readme)
    shutil.copy(rr.RESULTS, results)
    return str(readme), str(results)


def test_committed_table_is_current():
    r = subprocess.run([sys.executable, "-m",
                        "ivfhnsw_tpu_torch.tools.render_results", "--check"],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_measured_row_carries_the_card():
    with open(rr.README) as f:
        table = f.read().split(rr.START, 1)[1].split(rr.END, 1)[0]
    rows = [ln for ln in table.splitlines() if ln.startswith("| ")][1:]
    assert [ln.split(" | ")[0][2:] for ln in rows] == list(rr.ROWS)
    with open(rr.RESULTS) as f:
        snap = json.load(f)
    for ln in rows:
        stage = ln.split(" | ")[0][2:]
        if stage in snap["stages"]:
            assert snap["stages"][stage]["device"] in ln
            assert CARD in ln and "not measured" not in ln, ln
        else:
            assert "| not measured |" in ln, ln


def test_snapshot_holds_only_card_records():
    """Every stage of the committed snapshot was measured on the card at
    the tool's sizes, with its fields from the stage's own keys."""
    with open(rr.RESULTS) as f:
        snap = json.load(f)
    assert snap["stages"]
    for stage, e in snap["stages"].items():
        assert e["device"] == CARD and e["smoke"] is False, stage
        assert f"{stage}_stage_seconds" in e["fields"]
        assert e["recorded_at"].endswith("Z")


@pytest.mark.parametrize("field", ["recall_at_1", "us_per_query"])
def test_stale_number_fails_check(tmp_path, field):
    readme, results = _copies(tmp_path)
    assert rr.main(["--check", "--readme", readme, "--results",
                    results]) == 0
    with open(results) as f:
        snap = json.load(f)
    # the first stage in the table's order: its row shows both fields
    # (the snapshot's first key, build_1b, shows neither)
    stage = next(s for s in rr.ROWS if s in snap["stages"])
    pre = rr.ROWS[stage][1]
    snap["stages"][stage]["fields"][pre + field] = 0.123456
    with open(results, "w") as f:
        json.dump(snap, f)
    assert rr.main(["--check", "--readme", readme, "--results",
                    results]) == 1
    assert rr.main(["--readme", readme, "--results", results]) == 0
    with open(readme) as f:
        assert "0.1235" in f.read()
    assert rr.main(["--check", "--readme", readme, "--results",
                    results]) == 0


def _record(stages, device=CARD, at="2026-01-01T00:00:00Z", **fields):
    keys = {s: sorted(k for k in fields if k.startswith(s + "_"))
            for s in stages}
    return {"device": device, "smoke": False, "recorded_at": at,
            "stages_done": list(stages), "stage_keys": keys,
            "skipped_stages": [{"stage": "scale4", "cached": False,
                                "est_seconds": 5296.2,
                                "budget_left_seconds": 12,
                                "reason": "wall-clock budget"}], **fields}


def test_snapshot_merges_by_stage(tmp_path):
    """Records merge stage by stage; a later record replaces only its own
    stages; a skipped stage gets no row of numbers."""
    a = _record(["deep", "scale2"], at="2026-01-01T00:00:00Z",
                deep_us_per_query=4.5, deep_recall_at_1=0.4,
                deep_stage_seconds=100.0, scale2_us_per_query=7.0,
                scale2_stage_seconds=90.0)
    b = _record(["deep"], device="NVIDIA H100 80GB HBM3, 500.00 W",
                at="2026-01-02T00:00:00Z", deep_us_per_query=4.0,
                deep_stage_seconds=50.0)
    paths = []
    for i, rec in enumerate((a, b)):
        p = tmp_path / f"r{i}.jsonl"
        p.write_text("{\"partial\": 1}\n" + json.dumps(rec) + "\n")
        paths.append(str(p))
    readme = tmp_path / "README.md"
    readme.write_text(f"x\n{rr.START}\nold\n{rr.END}\ny\n")
    results = tmp_path / "snap.json"
    assert rr.main(["--snapshot", *paths, "--readme", str(readme),
                    "--results", str(results)]) == 0
    snap = json.loads(results.read_text())
    assert list(snap["stages"]) == ["deep", "scale2"]
    assert snap["stages"]["deep"] == {
        "fields": {"deep_us_per_query": 4.0, "deep_stage_seconds": 50.0},
        "device": "NVIDIA H100 80GB HBM3, 500.00 W", "smoke": False,
        "recorded_at": "2026-01-02T00:00:00Z"}
    assert snap["stages"]["scale2"]["device"] == CARD
    doc = readme.read_text()
    assert doc.startswith("x\n") and doc.endswith("y\n")
    rows = {ln.split(" | ")[0][2:]: ln for ln in doc.splitlines()
            if ln.startswith("| ") and not ln.startswith("| stage")}
    assert "500.00 W, 2026-01-02" in rows["deep"] and "| 4.0000 |" in \
        rows["deep"]
    assert CARD in rows["scale2"]
    for s in set(rr.ROWS) - {"deep", "scale2"}:
        assert "| not measured |" in rows[s], s


def test_not_measured_row(tmp_path):
    readme, results = _copies(tmp_path)
    with open(results) as f:
        snap = json.load(f)
    gone = next(iter(snap["stages"]))
    del snap["stages"][gone]
    with open(results, "w") as f:
        json.dump(snap, f)
    rr.main(["--readme", readme, "--results", results])
    with open(readme) as f:
        row = [ln for ln in f.read().splitlines()
               if ln.startswith(f"| {gone} |")]
    assert len(row) == 1 and "| not measured |" in row[0]
    assert CARD not in row[0]


def test_reads_no_jax_record(tmp_path, monkeypatch):
    """With ``open`` patched: --check and --snapshot open only the README,
    the snapshot and the records named, never a JAX RESULTS_*.json or a
    .bench_cache/ path."""
    readme, results = _copies(tmp_path)
    rec = tmp_path / "rec.json"
    rec.write_text(json.dumps(_record(["scale3"], scale3_us_per_query=4.6,
                                      scale3_stage_seconds=150.0)))
    seen = []
    real = builtins.open

    def spy(path, *a, **k):
        seen.append(os.path.abspath(str(path)))
        return real(path, *a, **k)

    monkeypatch.setattr(builtins, "open", spy)
    rr.main(["--check", "--readme", readme, "--results", results])
    rr.main(["--snapshot", str(rec), "--readme", readme, "--results",
             results])
    monkeypatch.undo()
    assert set(seen) == {readme, results, str(rec)}
    assert not [p for p in seen if ".bench_cache" in p
                or (os.path.basename(p).startswith("RESULTS_")
                    and p != rr.RESULTS)]
