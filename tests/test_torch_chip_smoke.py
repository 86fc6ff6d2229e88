"""chip_smoke.py: its CPU rehearsal runs every phase end to end, and the
card run refuses to report without a card or without the package."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd, timeout):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, SCRIPT if cwd == REPO else "chip_smoke.py",
                           *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cpu_rehearsal_runs_every_phase():
    out = _run(["--cpu-rehearsal"], REPO, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    for phase in ("device", "kernels", "index_documents", "search_batch",
                  "reference", "kernel timing", "P1 check", "impact tier",
                  "impact kernel timing", "levers kernel timing"):
        assert any(f"] {phase}" in ln for ln in lines), phase
    for phase in ("index_documents", "search_batch", "reference"):
        assert any(f"] {phase}: small-topic/source" in ln for ln in lines), phase
    for phase in ("search_batch", "reference"):
        assert any(f"] {phase}: small-topic/levers" in ln for ln in lines), phase
    assert any("] small-topic/levers: certified flags, ids and values equal the "
               "default run's bit for bit" in ln for ln in lines)
    assert any("] index_documents: regime 1" in ln for ln in lines)
    assert any("] regime 1: " in ln and "served twice is equal bit for bit" in ln
               for ln in lines)
    assert any("K1-K7 match" in ln for ln in lines)
    assert sum("bit-equal to super_scores True" in ln for ln in lines) == 4
    assert sum("bit-equal to window gather + place_windows True" in ln
               for ln in lines) == 2
    assert lines[-1] == '{"ok": true, "rehearsal": "cpu"}'
    assert '"platform": "gpu"' not in out.stdout


def test_p1_stages_rehearsal_finds_every_stage_repeating():
    out = _run(["--cpu-rehearsal", "--p1-stages"], REPO, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])["p1_stages"]
    assert last["first_differing_stage"] is None and all(last["stages"].values())
    assert last["same_batch_twice_on_one_build"] and last["same_batch_on_both_builds"]


def test_card_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run([], REPO, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_card_run_alone_fails(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run([], str(tmp_path), timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
