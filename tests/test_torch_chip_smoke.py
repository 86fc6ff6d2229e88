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
    pipelines = "small-topic/source/pipelines"
    for phase in ("pipelines funnel", "pipelines diversity", "pipelines hybrid_bm25",
                  "pipelines others", "pipelines chunked", "pipelines semantic cache"):
        assert any(f"] {phase}: {pipelines}" in ln for ln in lines), phase
    assert any("] pipelines funnel: " in ln and "stage 1 equals the exact dense top-100"
               in ln and "stage 2 equals BM25.candidate_scores" in ln for ln in lines)
    assert any("] pipelines diversity: " in ln and "MMR on the card equals its plain "
               "version on the host" in ln for ln in lines)
    assert any("] pipelines hybrid_bm25: " in ln and "rows exact" in ln for ln in lines)
    assert any("] pipelines chunked: " in ln and "restores the chunk map" in ln
               for ln in lines)
    assert any("] pipelines semantic cache: " in ln and "got all back" in ln
               for ln in lines)
    assert any(f"] {pipelines}: launches " in ln for ln in lines)
    # the other single-device routes: tile and impact ladders on the clustered
    # index, the kd_tiles rung, the one-call supertile entry, the sparse
    # hybrid and the IVF
    for run in ("small-topic/tile", "small-topic/impact"):
        for phase in ("search_batch", "reference"):
            assert any(f"] {phase}: {run}:" in ln for ln in lines), (phase, run)
        assert any(f"] {run}: " in ln and "served twice is equal bit for bit" in ln
                   for ln in lines), run
    assert any("] small-topic/impact/kd_tiles: hybrid_impact_topk(kd_tiles=128)" in ln
               and "served twice bit for bit" in ln for ln in lines)
    for s_probe in (2, 16):
        assert any(f"] small-topic/one-call: hybrid_supertile_topk(s_probe={s_probe})"
                   in ln and "equal bit for bit to super_prefix" in ln for ln in lines)
    assert any("] small-topic/source/sparse: hybrid_sparse_topk" in ln
               and "hot terms" in ln and "served twice is equal bit for bit" in ln
               and "match the plain exact fused reference" in ln for ln in lines)
    assert any("] ivf index: small-topic/ivf" in ln and "one corpus copy" in ln
               for ln in lines)
    assert any("] small-topic/ivf: " in ln and "full probe equals DenseIndex.search"
               in ln and "match the plain scatter reference" in ln for ln in lines)
    # the mesh: four gloo ranks serve small-topic, a quarter each, every rank
    # equal and every row exact; one batch on a world of one rank
    assert any("] index_documents: small-topic/mesh4: 4 ranks" in ln for ln in lines)
    assert any("] small-topic/mesh4: every rank's rows" in ln and "are equal" in ln
               for ln in lines)
    assert any("] small-topic/mesh4: all " in ln
               and "rows match the plain exact fused reference" in ln
               and "saved and loaded onto the mesh is equal bit for bit" in ln
               for ln in lines)
    assert sum(ln.startswith("    rank ") and "build" in ln for ln in lines) == 4
    assert any("] small-topic/mesh4: the first batch under HST_SUPER_HYBRID=0: "
               "the exact collective program once on every rank, all " in ln
               and "rows match the plain exact fused reference" in ln for ln in lines)
    assert any("shard of " in ln and "tile_scores at " in ln for ln in lines)
    assert any("] mesh world 1: gloo: one batch" in ln
               and "rows match the plain exact fused reference" in ln for ln in lines)
    # the API over HTTP on the minilm run's index, and the CLI chain
    api = "small-topic/source/api"
    for phase in ("api warmup", "api load", "api cache and batch", "api filtered",
                  "api funnel", "api mutations", "api cli"):
        assert any(f"] {phase}: {api}" in ln for ln in lines), phase
    assert any("] api warmup: " in ln and "warmup 7 dispatches" in ln for ln in lines)
    assert any("] api load: " in ln and "requests/s" in ln and "coalesced batch mean"
               in ln and "cache-key encode" in ln and "200 and uncached, every row "
               "equals search_batch" in ln for ln in lines)
    assert any("] api cache and batch: " in ln and "all cached and equal to their first "
               "responses" in ln and "equal the direct search_batch bit for bit" in ln
               for ln in lines)
    assert any("] api filtered: " in ln and "every row in group 3 and equal to the plain "
               "masked exact top-10" in ln and "all_metadata" in ln for ln in lines)
    assert any("] api funnel: " in ln and "equals run_funnel_batch" in ln for ln in lines)
    assert any("] api mutations: " in ln and "returns the new doc" in ln
               and "no longer return it" in ln for ln in lines)
    assert any("] api cli: " in ln and "python -m hybridsearch_tpu_torch index of" in ln
               and "start to healthy" in ln and "search --json" in ln for ln in lines)
    assert not os.path.exists(os.path.join(REPO, "chiprun_out", "api"))
    # the trainers: both one-device trainers held to the port on the CPU,
    # the train state and encoder round trips, the mesh step against the
    # one-device step
    for trainer in ("contrastive", "cross"):
        assert any(f"] train {trainer}: " in ln and "the first step's loss" in ln
                   and "every loss finite" in ln for ln in lines), trainer
    assert any("] train checkpoint: " in ln and "equals the uninterrupted step bit for "
               "bit" in ln and "equal the trainer's model in eval mode bit for bit" in ln
               for ln in lines)
    assert any("] train mesh: 4 gloo ranks" in ln and "data 2 x model 2" in ln
               and "every rank's loss" in ln for ln in lines)
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
