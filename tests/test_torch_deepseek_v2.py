"""The DeepSeek-V2 embedder (``models/deepseek_v2.py``) and the grouped
expert product (``ops/moe.py``) against the plain float32 reference
(``tests/_deepseek_v2_reference.py``), on the CPU at a small config with
seeded random weights: hidden 64, 4 heads, kv rank 16, rope 8 / nope 16 /
v 16, 8 routed experts (top 2) and 1 shared, 1 dense and 2 MoE layers,
vocabulary 512.

Tolerances:

- float32 trunk: embeddings within ``F32_ABS`` = 1e-5 of the reference
  (the same products summed in another order and grouping: tokens packed
  and batched, experts grouped);
- bf16 trunk (weights rounded to bf16, the reference given the same
  bf16-valued weights in float32), on unit embeddings, each text's
  largest absolute gap: their median within ``BF16_MEDIAN`` = 0.02 and
  every one within ``BF16_MAX`` = 0.1. Measured over four weight seeds:
  medians 0.0040-0.0046, largest 0.060 (every product's inputs rounded to
  bf16, RMSNorm, silu and RoPE outputs rounded once; the largest is a
  token near a router tie that took another expert). The reference with
  every product's inputs rounded to float8 e4m3's 3 mantissa bits reads
  medians 0.070-0.095, above ``BF16_MEDIAN``, so the bound tells the two
  precisions apart;
- token ids, YaRN tables and the softmax scale: exact (the same float32
  operations);
- the trunk's own runs of one text in other batches: within 1e-6 (a
  product's row may be summed in another blocking).

The card's test (marker ``gpu``; it skips inside its body without one)
checks ``expert_products`` and one batch of the encoder at the published
widths against the same reference on the card.
"""

import dataclasses

import _deepseek_v2_reference as ref
import numpy as np
import pytest
import torch

from hybridsearch_tpu_torch.models import deepseek_v2 as ds
from hybridsearch_tpu_torch.models.tokenizer import basic_tokenize
from hybridsearch_tpu_torch.ops import moe

CPU = torch.device("cpu")
F32_ABS = 1e-5
BF16_MEDIAN = 0.02
BF16_MAX = 0.1
SAME_ABS = 1e-6

SMALL = dict(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
             n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=16,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             bos_token_id=500, eos_token_id=501, n_word_ids=500)

TEXTS = [
    "What is the best way to learn Python?",
    "How do I learn python quickly",
    "Why is the sky blue?",
    "Café, naïve résumé — déjà vu!",
    "a",
    "",
    "What are the differences between machine learning, deep learning and statistics "
    "in practice, and which should a beginner start with?",
    "Is it possible to travel faster than light",
]


def small_cfg(dtype=torch.float32, **kw):
    return ds.DeepseekV2Config(**dict(SMALL, dtype=dtype, **kw))


def ref_cfg(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def state(cfg, seed=0):
    """Seeded weights of the small config: the matrices N(0, 0.2) (wider
    than the published 0.02, so the small trunk's states move), norms
    drawn around 1; float32, rounded to the config's dtype."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in ds.state_shapes(cfg).items():
        if "norm" in name:
            sd[name] = 1.0 + 0.1 * torch.randn(shape, generator=g)
        else:
            sd[name] = 0.2 * torch.randn(shape, generator=g)
    return {k: v.to(cfg.dtype) for k, v in sd.items()}


def encoder(cfg, sd, **kw):
    return ds.DeepseekV2Encoder(cfg, state_dict=sd, device=CPU, **kw)


def test_float32_trunk_matches_the_reference():
    cfg = small_cfg()
    sd = state(cfg)
    got = encoder(cfg, sd).encode(TEXTS)
    want = ref.embed(ref_cfg(cfg), sd, TEXTS)
    assert got.shape == (len(TEXTS), 64) and got.dtype == torch.float32
    assert torch.allclose(got.norm(dim=1), torch.ones(len(TEXTS)), atol=1e-6)
    assert (got - want).abs().max().item() < F32_ABS


def _gaps(a, b):
    """Each row's largest absolute difference."""
    return (a.float() - b.float()).abs().max(dim=1).values


def _round_e4m3_mantissa(x):
    """float32 values with 3 mantissa bits (float8 e4m3's), exponent kept."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 20) & 1
    return ((bits + 0x7FFFF + lsb) & ~0xFFFFF).view(torch.float32)


def test_bf16_trunk_within_its_bound_and_e4m3_outside_it(monkeypatch):
    cfg = small_cfg(torch.bfloat16)
    sd = state(cfg, seed=1)
    got = encoder(cfg, sd).encode(TEXTS)
    want = ref.embed(ref_cfg(cfg), sd, TEXTS)
    bf16_gaps = _gaps(got, want)
    assert bf16_gaps.median() < BF16_MEDIAN and bf16_gaps.max() < BF16_MAX
    monkeypatch.setattr(ref, "mm", lambda a, b: _round_e4m3_mantissa(a)
                        @ _round_e4m3_mantissa(b))
    e4m3_gaps = _gaps(ref.embed(ref_cfg(cfg), sd, TEXTS), want)
    assert e4m3_gaps.median() > BF16_MEDIAN, (bf16_gaps, e4m3_gaps)


def test_yarn_tables_and_softmax_scale_equal_the_reference():
    for cfg in (ds.DeepseekV2Config(), small_cfg()):
        cos, sin = ds.rope_tables(cfg, 300)
        rcos, rsin = ref.rope_cos_sin(ref_cfg(cfg), 300)
        assert torch.equal(cos, rcos) and torch.equal(sin, rsin)
        assert ds.softmax_scale(cfg) == ref.attention_scale(ref_cfg(cfg))
    published = ds.DeepseekV2Config()
    m = 0.1 * 0.707 * np.log(40) + 1.0
    assert ds.softmax_scale(published) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert ds.yarn_mscale(40, 0.707) / ds.yarn_mscale(40, 0.707) == 1.0


def test_tokenizer_matches_basic_tokenize_and_the_reference():
    cfg = small_cfg()
    every_ascii = "".join(chr(c) for c in range(128))
    for t in TEXTS + [every_ascii, "Ünïcode spaces　and 中文 punctuation。"]:
        assert ds.words(t) == basic_tokenize(t) == ref.words(t)
    tok = ds.WordHashTokenizer(cfg)
    for t, ids in zip(TEXTS, tok(TEXTS)):
        assert ids.tolist() == ref.tokenize(ref_cfg(cfg), t)
        assert ids[0] == cfg.bos_token_id and ids[-1] == cfg.eos_token_id
        assert (ids[1:-1] < cfg.n_word_ids).all()
    long = " ".join(f"w{i}" for i in range(600))
    cut = tok([long])[0]
    assert len(cut) == cfg.max_tokens and cut[-1] == cfg.eos_token_id


def _experts(T=37, E=6, H=24, I=10, seed=3, empty=2):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, E, (T,), generator=g)
    ids[ids == empty] = (empty + 1) % E
    ids = ids.sort().values
    x = torch.randn(T, H, generator=g)
    w13 = torch.randn(E, 2 * I, H, generator=g) / H ** 0.5
    w2 = torch.randn(E, H, I, generator=g) / I ** 0.5
    return ids, x, w13, w2


def _per_expert(ids, x, w13, w2):
    I = w2.shape[2]
    out = torch.empty(x.shape[0], w2.shape[1])
    for r in range(x.shape[0]):
        e = int(ids[r])
        h = w13[e] @ x[r]
        out[r] = w2[e] @ (torch.nn.functional.silu(h[:I]) * h[I:])
    return out


def test_expert_products_match_a_per_expert_loop_with_an_empty_expert():
    ids, x, w13, w2 = _experts()
    offsets = moe.expert_offsets(ids, w13.shape[0])
    assert offsets.dtype == torch.int32 and offsets[-1] == x.shape[0]
    assert offsets[2] == offsets[1]  # expert 2 takes no row
    got = moe.expert_products(x, w13, w2, offsets)
    assert torch.allclose(got, _per_expert(ids, x, w13, w2), atol=1e-5)


def test_moe_layer_matches_the_token_by_token_sum():
    g = torch.Generator().manual_seed(5)
    T, E, H, I, k = 29, 8, 16, 12, 3
    x = torch.randn(T, H, generator=g)
    gate = torch.randn(E, H, generator=g)
    gate[4] = -100.0 * x.mean(0) / x.mean(0).norm()  # an expert few tokens choose
    w13 = torch.randn(E, 2 * I, H, generator=g) / H ** 0.5
    w2 = torch.randn(E, H, I, generator=g) / I ** 0.5
    got = moe.moe_layer(x, gate, w13, w2, k)
    want = torch.zeros(T, H)
    for t in range(T):
        s = (x[t] @ gate.T).softmax(-1)
        w, e = torch.topk(s, k)
        for wj, ej in zip(w, e):
            want[t] += wj * _per_expert(ej[None], x[t:t + 1], w13, w2)[0]
    assert got.dtype == torch.float32
    assert torch.allclose(got, want, atol=1e-5)
    ids, weights = moe.route(x, gate, k)
    assert ids.shape == weights.shape == (T, k) and weights.dtype == torch.float32
    assert (weights[:, :-1] >= weights[:, 1:]).all()


def test_pad_tokens_take_no_expert_slot_and_neighbours_change_nothing(monkeypatch):
    cfg = small_cfg()
    enc = encoder(cfg, state(cfg, seed=2))
    seen = []
    real = moe.expert_products

    def recording(x_sorted, w13, w2, offsets):
        seen.append(int(offsets[-1]))
        return real(x_sorted, w13, w2, offsets)

    monkeypatch.setattr(moe, "expert_products", recording)
    batch = enc.encode(TEXTS)
    n_real = sum(len(t) for t in enc.tokenizer(TEXTS))
    # one chunk, two MoE layers: every slot is a real token's
    assert seen == [n_real * cfg.num_experts_per_tok] * 2
    for i, t in enumerate(TEXTS):
        alone = enc.encode([t])
        assert (alone[0] - batch[i]).abs().max().item() < SAME_ABS
    # another chunking (two texts a chunk) and another order
    rev = enc.encode(TEXTS[::-1], batch_size=2)
    assert (rev.flip(0) - batch).abs().max().item() < SAME_ABS


def test_counters_count_texts_tokens_padding_and_routed_tokens():
    from hybridsearch_tpu_torch.utils.tracing import GLOBAL_COUNTERS

    cfg = small_cfg()
    enc = encoder(cfg, state(cfg))
    names = ("encoder_texts", "encoder_tokens", "encoder_tokens_padded", "moe_tokens_routed")
    before = {n: GLOBAL_COUNTERS.get(n) for n in names}
    enc.encode(TEXTS[:3], batch_size=2)
    lens = sorted(len(t) for t in enc.tokenizer(TEXTS[:3]))
    pad = lambda n: -(-n // 8) * 8  # noqa: E731
    want = {"encoder_texts": 3, "encoder_tokens": sum(lens),
            "encoder_tokens_padded": 2 * pad(lens[1]) + pad(lens[2]),
            "moe_tokens_routed": 2 * sum(lens)}
    assert {n: GLOBAL_COUNTERS.get(n) - before[n] for n in names} == want


def test_config_reads_the_published_keys_and_refuses_what_it_lacks():
    published = {"hidden_size": 2048, "kv_lora_rank": 512, "model_type": "deepseek_v2",
                 "attention_bias": False, "num_hidden_layers": 27, "q_lora_rank": None}
    cfg = ds.DeepseekV2Config.from_dict(published, num_hidden_layers=5)
    assert cfg.num_hidden_layers == 5 and cfg.qk_head_dim == 192
    assert [cfg.is_moe(i) for i in range(3)] == [False, True, True]
    for bad in ({"q_lora_rank": 1536}, {"topk_method": "group_limited_greedy"},
                {"norm_topk_prob": True}):
        with pytest.raises(ValueError):
            ds.DeepseekV2Config(**bad)


def test_searcher_and_indexer_serve_the_trunk():
    from hybridsearch_tpu_torch.config import EngineConfig
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    cfg = small_cfg()
    enc = encoder(cfg, state(cfg, seed=4))
    rng = np.random.default_rng(0)
    vocab = [f"word{i}" for i in range(120)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(3, 12))) + "?" for _ in range(300)]
    ec = EngineConfig()
    s = Searcher(config=ec, encoder=enc, use_query_memory=False, device=CPU)
    s.indexer.index_documents(docs)
    assert ec.index.dim == 64
    queries = [docs[5], docs[77], docs[250]]
    rows = s.search_batch(queries, top_k=5, log=False)
    assert [len(r) for r in rows] == [5, 5, 5]
    for q, r in zip(queries, rows):
        assert r[0][1] == q  # the query's own text: cosine 1 and the top BM25 score


def test_default_encoder_serves_the_trunk(monkeypatch):
    from hybridsearch_tpu_torch.models.encoder import default_encoder

    cfg = small_cfg()
    enc = default_encoder(dim=64, kind="deepseek_v2", device=CPU, config=cfg, seed=3)
    assert isinstance(enc, ds.DeepseekV2Encoder) and enc.dim == 64
    monkeypatch.setenv("HST_ENCODER", "deepseek_v2")
    sd = state(cfg)
    enc = default_encoder(dim=64, device=CPU, config=cfg, state_dict=sd)
    assert torch.equal(enc.encode(TEXTS[:2]), encoder(cfg, sd).encode(TEXTS[:2]))
    with pytest.raises(ValueError):
        default_encoder(dim=384, kind="deepseek_v2", device=CPU, config=cfg)


@pytest.mark.gpu
def test_expert_products_and_one_batch_on_the_card():
    """At the published widths (two layers: the dense one and one MoE
    layer), bf16 on the card against the reference in float32 on the card
    with the same bf16-valued weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    E, H, I, T = 64, 2048, 1408, 3000
    ids = torch.randint(0, E, (T,), device=dev, generator=g)
    ids[ids == 7] = 8
    ids = ids.sort().values
    x = torch.randn(T, H, device=dev, generator=g).bfloat16()
    w13 = (0.02 * torch.randn(E, 2 * I, H, device=dev, generator=g)).bfloat16()
    w2 = (0.02 * torch.randn(E, H, I, device=dev, generator=g)).bfloat16()
    got = moe.expert_products(x, w13, w2, moe.expert_offsets(ids, E)).float()
    xf, w13f, w2f = x.float(), w13.float(), w2.float()
    want = torch.empty_like(got)
    for e in range(E):
        rows = (ids == e).nonzero().flatten()
        h = xf[rows] @ w13f[e].T
        want[rows] = (torch.nn.functional.silu(h[:, :I]) * h[:, I:]) @ w2f[e].T
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() < 0.02 * scale

    cfg = ds.DeepseekV2Config(num_hidden_layers=2)
    sd = ds.random_state_dict(cfg, 11, dev)
    texts = TEXTS * 4
    emb = ds.DeepseekV2Encoder(cfg, state_dict=sd, device=dev).encode(texts)
    gaps = _gaps(emb, ref.embed(ref_cfg(cfg), sd, texts))
    assert gaps.median() < BF16_MEDIAN and gaps.max() < BF16_MAX
