"""The port stands alone: importing it (every submodule) pulls in neither
JAX nor the JAX package, and its sources import neither. Checked in a
subprocess, since other test files import JAX into this one."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, importlib.util, pkgutil, sys
import hybridsearch_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, "hybridsearch_tpu_torch."):
    # the FastAPI adapter imports fastapi at import, as the JAX package's
    # does: where fastapi is not installed it is the one module left out
    if m.name.endswith(".fastapi_app") and importlib.util.find_spec("fastapi") is None:
        continue
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "hybridsearch_tpu"))
print(len([m for m in sys.modules if m.startswith("hybridsearch_tpu_torch")]))
sys.exit(1 if bad else 0)
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.strip()) >= 20  # every submodule was imported


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|hybridsearch_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "hybridsearch_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_entry_points_default_to_the_card():
    """device=None means the card: without one it raises, never falls back."""
    from hybridsearch_tpu_torch.index.builder import Indexer
    from hybridsearch_tpu_torch.pipelines import create_pipeline
    from hybridsearch_tpu_torch.services.semantic_cache import SemanticCache
    from hybridsearch_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            Indexer()
        with pytest.raises(RuntimeError):
            create_pipeline("basic")
        with pytest.raises(RuntimeError):
            SemanticCache()
    import hybridsearch_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


_ROUTES_PROBE = """
import sys
from hybridsearch_tpu_torch.index.builder import IVF_AUTO_MIN_DOCS, Indexer
from hybridsearch_tpu_torch.index.ivf import IVFIndex
from hybridsearch_tpu_torch.ops.bm25 import encode_hot_terms
from hybridsearch_tpu_torch.ops.hybrid import hybrid_sparse_topk, hybrid_tile_topk
from hybridsearch_tpu_torch.ops.supertile import hybrid_supertile_topk
from hybridsearch_tpu_torch.retrieval.searcher import impact_ladder, tile_ladder
from hybridsearch_tpu_torch.convert import ivf_index
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "hybridsearch_tpu"))
sys.exit(1 if bad else 0)
"""


def test_the_single_device_routes_import_no_jax():
    """The tile, sparse and one-call supertile hybrids, the tile ladder, the
    IVF index and its converter load in a process with no JAX module."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _ROUTES_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_ivf_index_defaults_to_the_card():
    from hybridsearch_tpu_torch.index.ivf import IVFIndex

    assert IVFIndex(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert IVFIndex().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            IVFIndex()


_API_PROBE = """
import sys
from hybridsearch_tpu_torch.api import EngineState, Router, build_router
from hybridsearch_tpu_torch.api.batching import BatchTimeout, SearchBatcher
from hybridsearch_tpu_torch.api.cli import main
from hybridsearch_tpu_torch.api.httpd import APIServer, make_handler, serve
from hybridsearch_tpu_torch.api.schemas import ROUTE_SPECS, build_openapi
from hybridsearch_tpu_torch.api.webui import HTML_PAGE, streamlit_app
from hybridsearch_tpu_torch.demo import run_demo
import hybridsearch_tpu_torch.__main__
from hybridsearch_tpu_torch.evaluation import beir, harness, metrics, multilingual, oracle
from hybridsearch_tpu_torch.evaluation import ood_english, synth_beir
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "hybridsearch_tpu",
                                    "pydantic", "fastapi", "streamlit", "requests"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_the_api_demo_and_evaluation_import_no_jax():
    """The API, the CLI, ``python -m``'s module, the demo and the
    evaluation package load with no JAX module, and without pydantic,
    fastapi, streamlit or requests (the card's machine has none of them;
    each is imported where a route or a UI needs it)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _API_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_engine_state_defaults_to_the_card():
    from hybridsearch_tpu_torch.api.app import EngineState

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EngineState()
