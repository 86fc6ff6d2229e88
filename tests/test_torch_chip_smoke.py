"""chip_smoke.py: its CPU rehearsal runs every phase end to end, and the
card run refuses to report without a card or without the package;
chip_probes.py refuses to run without a card."""

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
    # pass 3 of the source path's dense top-k, K4 at tile grain, is checked
    # on the path's own inputs
    assert any("] impact kernel timing:" in ln and "pass 3 at" in ln for ln in lines)
    assert sum("bit-equal to window gather + place_windows True" in ln
               for ln in lines) == 2
    # K5 and K7 are held to their first designs (which run on the card only)
    assert sum("to place_fused_v1 None" in ln for ln in lines) == 2
    assert sum("rescore bit-equal to rescore_v1 None" in ln for ln in lines) == 2
    # the redesigned kernels' rows: K1 at every batch size of both paths
    # that run it, K3 at every rung of the clustered path
    assert any("] redesigned kernels: tile_stats at B = " in ln for ln in lines)
    assert any(ln.startswith("    tile_stats small-topic B=") for ln in lines)
    assert any(ln.startswith("    tile_stats small-topic/source B=") for ln in lines)
    assert any(ln.startswith("    place_windows B*S=") for ln in lines)
    minilm = "small-topic/source/minilm"
    assert any(f"] index_documents: {minilm}" in ln and "tokenize_s" in ln
               and "trunk_s" in ln for ln in lines)
    for phase in ("search_batch", "reference"):
        assert any(f"] {phase}: {minilm}" in ln for ln in lines), phase
    assert any(f"] {minilm}: " in ln and "hst-bi-tiny (in-repo-trained" in ln
               and "encode span" in ln for ln in lines)
    assert any("] cross-encoder: " in ln and "CrossEncoderReranker.rerank" in ln
               for ln in lines)
    lifecycle = "small-topic/source/lifecycle"
    for phase in ("lifecycle build", "lifecycle serve", "lifecycle vs one-shot",
                  "lifecycle delete", "lifecycle save/load", "lifecycle scatter"):
        assert any(f"] {phase}: {lifecycle}" in ln for ln in lines), phase
    assert any("] lifecycle build: " in ln and "wait in the delta" in ln for ln in lines)
    assert any("] lifecycle vs one-shot: " in ln and "triples equal bit for bit" in ln
               for ln in lines)
    assert any("] lifecycle save/load: " in ln and "bit for bit" in ln for ln in lines)
    assert any("] lifecycle scatter: " in ln and "match the plain scatter reference"
               in ln for ln in lines)
    for phase in ("search_batch", "reference"):
        for run in ("", "/deleted", "/reloaded"):
            assert any(f"] {phase}: {lifecycle}{run}:" in ln for ln in lines), (phase, run)
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


def test_probes_without_a_card_print_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_probes.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"k1"' not in out.stdout and "no CUDA card" in out.stderr
