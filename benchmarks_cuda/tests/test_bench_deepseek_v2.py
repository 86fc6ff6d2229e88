"""The ``deepseek_v2`` encoder kind (``encoders/deepseek_v2.py``) at a small
config on the CPU (hidden 64, 4 heads, kv rank 16, rope 8 / nope 16 / v 16,
8 routed experts (top 2) and 1 shared, 1 dense and 2 MoE layers,
vocabulary 512):

- its ``Embedder`` equals the tests' plain reference
  (``tests/_deepseek_v2_reference.py``) on the same drawn weights, within
  1e-5 (the same float32 products, grouped in blocks and by expert);
- loading it, drawing and embedding load nothing of the program, of the
  JAX package or of JAX;
- ``program`` (the port's bf16 trunk) and ``Embedder`` over one ``draw``
  agree within the tier-1 tests' bf16 bounds on unit embeddings (each
  text's largest gap: median under 0.02, every one under 0.1), and the
  control (``precision="tf32"``: e4m3 mantissas) lies farther from the
  reference than that median bound;
- ``draw`` is the same from the same seed, and other from another.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
CPU = torch.device("cpu")
SMALL = dict(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
             n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=16,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
TEXTS = ["What is the best way to learn Python?", "How do I learn python quickly",
         "Why is the sky blue?", "Café, naïve résumé — déjà vu!", "a", "",
         "What are the differences between machine learning, deep learning and statistics "
         "in practice, and which should a beginner start with?",
         "Is it possible to travel faster than light"] * 3


def small_config(std=0.2, seed=7):
    cfg = json.loads((BENCH / "configs" / "beir-quora.dsv2lite.json").read_text())
    cfg.update(SMALL)
    cfg["encoder"].update(bos_token_id=500, eos_token_id=501, n_word_ids=500,
                          initializer_range=std, weight_seed=seed, dim=64)
    return cfg


def kind():
    from harness import kinds

    return kinds.load(BENCH / "encoders", "deepseek_v2")


def _gaps(a, b):
    return (a.float() - b.float()).abs().max(dim=1).values


def test_embedder_equals_the_tests_reference():
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import _deepseek_v2_reference as ref
    finally:
        sys.path.remove(str(REPO / "tests"))
    k, cfg = kind(), small_config()
    sd = k.draw(cfg, CPU)
    got = k.Embedder(cfg, sd).embed(TEXTS)
    m = dict(cfg, **{key: cfg["encoder"][key] for key in
                     ("bos_token_id", "eos_token_id", "n_word_ids", "max_tokens")})
    want = ref.embed(m, sd, TEXTS)
    assert got.shape == (len(TEXTS), 64)
    assert (got - want).abs().max().item() < 1e-5


def test_the_kind_loads_nothing_of_the_program_or_jax():
    code = f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]
sys.path.insert(0, {str(BENCH / 'tests')!r})
import torch
from test_bench_deepseek_v2 import TEXTS, kind, small_config
k, cfg = kind(), small_config()
sd = k.draw(cfg, torch.device("cpu"))
k.Embedder(cfg, sd).embed(TEXTS)
k.Embedder(cfg, sd, "tf32").embed(TEXTS)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "hybridsearch_tpu",
                                               "hybridsearch_tpu_torch"))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(REPO)).stdout.strip().splitlines()[-1]
    assert json.loads(out) == []


def test_program_and_embedder_agree_over_one_draw():
    k, cfg = kind(), small_config()
    sd = k.draw(cfg, CPU)
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    want = k.Embedder(cfg, sd).embed(TEXTS)
    got = k.program(cfg, sd, CPU).encode(TEXTS)
    gaps = _gaps(got, want)
    assert gaps.median() < 0.02 and gaps.max() < 0.1, gaps
    control = _gaps(k.Embedder(cfg, sd, "tf32").embed(TEXTS), want)
    assert control.median() > 0.02, control


def test_draw_follows_the_weight_seed():
    k = kind()
    a, b = k.draw(small_config(seed=7), CPU), k.draw(small_config(seed=7), CPU)
    c = k.draw(small_config(seed=8), CPU)
    name = "model.layers.1.mlp.experts.3.up_proj.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    with pytest.raises(ValueError):
        k.Embedder(small_config(), a, "fp16")
