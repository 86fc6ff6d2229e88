"""The port's tokenizer, transformer trunk, bi-encoder, cross-encoder,
checkpoint handling, encoders and rerankers against the JAX package's, on
the CPU, fed the same numpy inputs made from a seed.

Tolerances:

- float32 activations: within 1e-4 (absolute) of the Flax modules, at a
  tiny config and on both in-repo checkpoints; the sums run in another
  order.
- bfloat16 activations (the default): the two packages round in places
  XLA may fuse away, so each bound is stated from the spread measured on
  these inputs. Measured: tiny config 4.8e-4 on trunk states, 3.1e-5 on
  embeddings, 6.5e-5 on logits; in-repo checkpoints 0.0017 max-abs and
  0.99998 least cosine between embeddings, 0.018 between logits of one
  forward and 0.060 through ``predict`` (logits up to 5.6). Bounds:
  ``BF16_STATE_ABS`` 5e-3 on trunk states, ``BF16_EMB_ABS`` 1e-2 and
  ``BF16_EMB_COS`` 0.999 on unit embeddings, ``BF16_LOGIT_ABS`` 0.15 on
  logits.
- Token ids, byte-trigram features and checkpoint arrays: exact.
- Rankings: equal ids except where two scores lie within the stated bound
  (a near-tie the rounding may swap).
"""

import dataclasses
import json
import os
import warnings

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from hypothesis import given, settings
from hypothesis import strategies as st

from hybridsearch_tpu.models import bert as jb
from hybridsearch_tpu.models import encoder as jenc
from hybridsearch_tpu.models import minilm as jm
from hybridsearch_tpu.models import tokenizer as jtok
from hybridsearch_tpu.retrieval import reranker as jrr
from hybridsearch_tpu_torch.convert import bert_flat, bert_state
from hybridsearch_tpu_torch.models import bert as tb
from hybridsearch_tpu_torch.models import encoder as tenc
from hybridsearch_tpu_torch.models import minilm as tm
from hybridsearch_tpu_torch.models import tokenizer as ttok
from hybridsearch_tpu_torch.retrieval import reranker as trr

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BI_CKPT = os.path.join(REPO, "models", "hst-bi-v3")
CE_CKPT = os.path.join(REPO, "models", "hst-ms-marco-MiniLM-L-6-v2-synth")

F32_ABS = 1e-4
BF16_EMB_ABS = 1e-2
BF16_EMB_COS = 0.999
BF16_LOGIT_ABS = 0.15
BF16_STATE_ABS = 5e-3

TINY = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128,
            max_position=64)

TEXTS = [
    "the quick brown fox jumps over the lazy dog.",
    "hybrid search engines fuse dense and sparse queries",
    "dog!",
    "t12x3 t12x5 w17 w9 w1000 t12x1",
    "A longer document, with punctuation; CAPITALS -- numbers 12345, and more "
    "words than the others have, to reach another sequence bucket entirely.",
    "",
    "café au lait résumé",
    "x" * 150,
]


def _cfgs(dtype_j, dtype_t, **kw):
    spec = dict(TINY, **kw)
    return jb.BertConfig(dtype=dtype_j, **spec), tb.BertConfig(dtype=dtype_t, **spec)


def _flat(params) -> dict:
    """Flat "params/..." numpy arrays of a Flax tree (partition boxes off)."""
    params = flax.core.meta.unbox(params)
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


def _inputs(rng, B=6, L=16, vocab=512):
    ids = rng.integers(5, vocab, (B, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    types = ((np.arange(L)[None, :] >= (lens // 2)[:, None]) * mask).astype(np.int32)
    return ids, mask, types


def _torch(*arrays):
    return [torch.from_numpy(a.astype(np.int64)) for a in arrays]


def _unit_close(got, want, abs_tol, cos_tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= abs_tol
    assert (got * want).sum(axis=1).min() >= cos_tol


# -- the trunk and its heads at a tiny config -------------------------------------

MODULES = {"trunk": (jb.BertEncoder, tb.BertEncoder, 3),
           "bi": (jb.BiEncoder, tb.BiEncoder, 2),
           "cross": (jb.CrossEncoder, tb.CrossEncoder, 3)}


@pytest.mark.parametrize("which", list(MODULES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_modules_match_flax(which, dtype):
    """Flax init, carried by ``bert_state``; ``bert_flat`` gives the Flax
    arrays back exactly."""
    J, T, n_in = MODULES[which]
    jcfg, tcfg = _cfgs(getattr(jnp, dtype), getattr(torch, dtype))
    ids, mask, types = _inputs(np.random.default_rng(0))
    args = (ids, mask, types)[:n_in]
    jmod = J(jcfg)
    params = jmod.init(jax.random.PRNGKey(1), *map(jnp.asarray, args))
    want = np.asarray(jmod.apply(params, *map(jnp.asarray, args)), np.float32)
    flat = _flat(params)
    tmod = T(tcfg)
    tmod.load_state_dict(bert_state(flat), strict=True)
    with torch.no_grad():
        got = tmod(*_torch(*args)).float().numpy()
    if which == "trunk":  # pad positions' states are not read by any head
        got, want = got * mask[..., None], want * mask[..., None]
    tol = F32_ABS if dtype == "float32" else {"trunk": BF16_STATE_ABS, "bi": BF16_EMB_ABS,
                                              "cross": BF16_LOGIT_ABS}[which]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    back = bert_flat(tmod)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_seeded_init_draws_the_flax_distributions():
    """Same seed, same weights; normal(0.02) kernels, normal(1/sqrt(H))
    embeddings, lecun_normal head, zero biases, unit LayerNorm scales."""
    _jcfg, tcfg = _cfgs(jnp.float32, torch.float32, hidden_dim=256, mlp_dim=512,
                        vocab_size=4096)
    a, b = tb.CrossEncoder(tcfg), tb.CrossEncoder(tcfg)
    tb.init_params(a, torch.Generator().manual_seed(3))
    tb.init_params(b, torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    sd = a.state_dict()
    assert abs(float(sd["bert.layer_0.mlp_in.weight"].std()) - 0.02) < 1e-3
    assert abs(float(sd["bert.word_embeddings.weight"].std()) - 1 / 16) < 2e-3
    pooler = sd["pooler.weight"]
    assert abs(float(pooler.std()) - 1 / 16) < 3e-3
    assert float(pooler.abs().max()) <= 2 / 16 / 0.87962566103423978 + 1e-6
    assert not sd["bert.layer_1.attention.query.bias"].any()
    assert torch.equal(sd["bert.layer_1.mlp_ln.weight"], torch.ones(256))


# -- the in-repo checkpoints ----------------------------------------------------------

def _checkpoint_pair(ckpt, J, T, dtype):
    jparams, jcfg = jm.load_trained_checkpoint(ckpt)
    flat, tcfg = tm.load_trained_checkpoint(ckpt)
    assert flat.keys() == _flat(jparams).keys()
    jmod = J(dataclasses.replace(jcfg, dtype=getattr(jnp, dtype)))
    tmod = T(dataclasses.replace(tcfg, dtype=getattr(torch, dtype)))
    tmod.load_state_dict(bert_state(flat), strict=True)
    return jparams, jmod, tmod.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_repo_checkpoints_match_flax(dtype):
    tok = ttok.BertTokenizer(vocab_size=8192)
    ids, mask = tok.batch_encode(TEXTS, 64)
    jparams, jmod, tmod = _checkpoint_pair(BI_CKPT, jb.BiEncoder, tb.BiEncoder, dtype)
    want = np.asarray(jmod.apply(jparams, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tmod(*_torch(ids, mask)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ABS)
    else:
        _unit_close(got, want, BF16_EMB_ABS, BF16_EMB_COS)

    pairs = [(TEXTS[i], TEXTS[j]) for i in range(len(TEXTS)) for j in (0, 4)]
    ids, types, mask = tok.batch_encode_pairs(pairs, 128)
    jparams, jmod, tmod = _checkpoint_pair(CE_CKPT, jb.CrossEncoder, tb.CrossEncoder, dtype)
    want = np.asarray(jmod.apply(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                 jnp.asarray(types)))
    with torch.no_grad():
        got = tmod(*_torch(ids, mask, types)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_ABS if dtype == "float32" else BF16_LOGIT_ABS)


def _many_texts(rng, n):
    words = [f"w{i}" for i in range(300)] + ["fox", "dog", "search", "Engine!"]
    return [" ".join(rng.choice(words, size=int(rng.integers(0, 70)))) for _ in range(n)]


def test_encode_and_predict_match_jax_on_the_checkpoints(monkeypatch):
    """Through tokenization, the length sort, the batch and sequence buckets
    (more than one chunk, a padded batch), and the cross-encoder's token
    budget groups (several dispatches), in bf16."""
    texts = TEXTS + _many_texts(np.random.default_rng(1), 70)
    je = jm.MiniLMEncoder(checkpoint=BI_CKPT)
    te = tm.MiniLMEncoder(checkpoint=BI_CKPT, device=CPU)
    assert (te.dim, te.max_seq_len, te.weights_origin) == (je.dim, je.max_seq_len,
                                                          je.weights_origin)
    got = te.encode(texts, batch_size=32)
    assert got.dtype == torch.float32 and got.device == CPU
    _unit_close(got.numpy(), je.encode(texts, batch_size=32), BF16_EMB_ABS, BF16_EMB_COS)

    monkeypatch.setenv("HST_CE_MAX_TOKENS", "1024")
    pairs = [(texts[i], texts[(7 * i + 3) % len(texts)]) for i in range(60)]
    jc = jm.MiniLMCrossEncoder(checkpoint=CE_CKPT)
    tc = tm.MiniLMCrossEncoder(checkpoint=CE_CKPT, device=CPU)
    js, ts = {}, {}
    want = jc.predict(pairs, stats=js)
    got = tc.predict(pairs, stats=ts)
    assert ts == js and js["dispatches"] > 3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_LOGIT_ABS)


def _carried_tiny_encoder(dtype=jnp.float32):
    """A tiny random JAX MiniLMEncoder and the port's with its weights."""
    jcfg, tcfg = _cfgs(dtype, torch.float32 if dtype == jnp.float32 else torch.bfloat16,
                       vocab_size=1024)
    je = jm.MiniLMEncoder(dim=64, cfg=jcfg, max_seq_len=32, seed=2)
    te = tm.MiniLMEncoder(dim=64, cfg=tcfg, max_seq_len=32, device=CPU)
    te.model.load_state_dict(bert_state(_flat(je.params)), strict=True)
    return je, te


def test_encode_pipeline_matches_jax_in_float32():
    """The whole encode contract (sort, chunks, buckets, padded rows with
    mask[:, 0] = 1, max_seq_len capped by max_position) within 1e-4."""
    je, te = _carried_tiny_encoder()
    texts = TEXTS + _many_texts(np.random.default_rng(2), 100)
    for bs in (64, 7):
        np.testing.assert_allclose(te.encode(texts, batch_size=bs).numpy(),
                                   je.encode(texts, batch_size=bs), rtol=0, atol=F32_ABS)
    alone = te.encode(["dog!"])
    inside = te.encode(["dog!", "the quick brown fox " * 5])[:1]
    np.testing.assert_allclose(alone.numpy(), inside.numpy(), rtol=0, atol=1e-5)
    assert te.encode([]).shape == (0, 64)


# -- the tokenizer -----------------------------------------------------------------------

WP_VOCAB = ([jtok.PAD, jtok.UNK, jtok.CLS, jtok.SEP, jtok.MASK]
            + ["the", "quick", "brown", "fox", "jump", "over", "lazy", "dog", "search",
               "engine", "hybrid", "caf", "cafe", "##s", "##ing", "##er", "##es", "##e",
               ".", ",", "!", "?", ";", "-"])


@pytest.mark.parametrize("backend", ["hashed", "wordpiece"])
def test_tokenizer_ids_match_jax(tmp_path, backend):
    path = None
    if backend == "wordpiece":
        path = tmp_path / "vocab.txt"
        path.write_text("\n".join(WP_VOCAB) + "\n", encoding="utf-8")
        path = str(path)
    j = jtok.BertTokenizer(vocab_path=path, vocab_size=8192)
    t = ttok.BertTokenizer(vocab_path=path, vocab_size=8192)
    texts = TEXTS + ["Jumping foxes... QUERIES!", "unknownword dog", "Cafés été 中文"]
    assert t.vocab_size == j.vocab_size
    for text in texts:
        for ml in (8, 16, 256):
            assert t.encode(text, ml) == j.encode(text, ml)
            assert t.encode_pair(text, texts[1], ml) == j.encode_pair(text, texts[1], ml)
    for ml in (8, 64):
        for got, want in zip(t.batch_encode(texts, ml), j.batch_encode(texts, ml)):
            np.testing.assert_array_equal(got, want)
        pairs = list(zip(texts, reversed(texts)))
        for got, want in zip(t.batch_encode_pairs(pairs, ml), j.batch_encode_pairs(pairs, ml)):
            np.testing.assert_array_equal(got, want)
    assert ttok._bucket(9, 8) == jtok._bucket(9, 8) == 16


def _per_text(tok, texts, max_len):
    """batch_encode built from the per-text ``encode``: the reference the
    vectorised ASCII path must equal."""
    enc = [tok.encode(t, max_len) for t in texts]
    L = min(max_len, ttok._bucket(max((len(e) for e in enc), default=1), 8))
    ids = np.zeros((len(texts), L), np.int32)
    mask = np.zeros((len(texts), L), np.int32)
    for i, e in enumerate(enc):
        ids[i, :len(e)] = e
        mask[i, :len(e)] = 1
    return ids, mask


_ASCII = st.text(alphabet=st.characters(min_codepoint=0, max_codepoint=127), max_size=60)
_LONG = st.builds(lambda c, n: c * n, st.sampled_from("aZ9\x00\x7f"),
                  st.integers(95, 130))
_DOC = st.lists(st.one_of(_ASCII, _LONG), min_size=1, max_size=4).map(" ".join)


@settings(max_examples=60, deadline=None)
@given(texts=st.lists(_DOC, min_size=1, max_size=6),
       max_len=st.sampled_from([2, 3, 8, 40, 256, 600]),
       lowercase=st.booleans())
def test_vectorised_ascii_path_equals_the_per_text_path(texts, max_len, lowercase):
    """Every ASCII code point (isspace 9-13 and 28-31, the four punctuation
    ranges, control bytes inside words), words over 100 characters (hashed
    whole, as the JAX HashedVocab does) and bodies cut at max_len - 2."""
    vec = ttok.BertTokenizer(vocab_size=8192, lowercase=lowercase)
    ref = ttok.BertTokenizer(vocab_size=8192, lowercase=lowercase)
    got = vec.batch_encode(texts, max_len)
    assert not vec._seq_cache  # the bulk path fills no memo
    for g, w in zip(got, _per_text(ref, texts, max_len)):
        np.testing.assert_array_equal(g, w)
    jt = jtok.BertTokenizer(vocab_size=8192, lowercase=lowercase)
    for g, w in zip(got, jt.batch_encode(texts, max_len)):
        np.testing.assert_array_equal(g, w)


def test_non_ascii_batch_takes_the_per_text_path():
    t = ttok.BertTokenizer(vocab_size=8192)
    texts = ["plain ascii", "naïve café"]
    got = t.batch_encode(texts, 16)
    assert set(t._seq_cache) == set(texts)
    for g, w in zip(got, jtok.BertTokenizer(vocab_size=8192).batch_encode(texts, 16)):
        np.testing.assert_array_equal(g, w)


# -- checkpoints both ways ------------------------------------------------------------

def test_checkpoints_carry_both_ways(tmp_path):
    """The port's save read by the JAX package, and the reverse: the same
    arrays, and the same float32 embeddings."""
    jcfg, tcfg = _cfgs(jnp.float32, torch.float32)
    ids, mask, _ = _inputs(np.random.default_rng(3))
    port = tb.BiEncoder(tcfg)
    tb.init_params(port, torch.Generator().manual_seed(5))
    tm.save_trained_checkpoint(port, tcfg, str(tmp_path / "from-port"), note="port")
    jparams, jcfg_read = jm.load_trained_checkpoint(str(tmp_path / "from-port"))
    assert dataclasses.replace(jcfg_read, dtype=jnp.float32) == jcfg
    want = jb.BiEncoder(jcfg).apply(jparams, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = port(*_torch(ids, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ABS)

    jmod = jb.BiEncoder(jcfg)
    params = jmod.init(jax.random.PRNGKey(4), jnp.asarray(ids), jnp.asarray(mask))
    jm.save_trained_checkpoint(params, jcfg, str(tmp_path / "from-jax"))
    flat, tcfg_read = tm.load_trained_checkpoint(str(tmp_path / "from-jax"))
    assert dataclasses.replace(tcfg_read, dtype=torch.float32) == tcfg
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(flat[k], v)
    port = tb.BiEncoder(tcfg)
    port.load_state_dict(bert_state(flat), strict=True)
    with torch.no_grad():
        got = port(*_torch(ids, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmod.apply(params, jnp.asarray(ids),
                                                                  jnp.asarray(mask))),
                               rtol=0, atol=F32_ABS)
    assert tm.checkpoint_dim(str(tmp_path / "from-jax")) == 64
    enc = tm.MiniLMEncoder(checkpoint=str(tmp_path / "from-jax"), device=CPU)
    assert (enc.weights_origin, enc.dim, enc.cfg.num_layers) == ("in-repo-trained", 64, 2)


def test_convert_hf_bert_matches_jax_and_transformers(tmp_path):
    """A tiny HF checkpoint made in the test (as tests/test_hf_conversion.py
    does): the port's conversion equals the JAX package's, and both
    wrappers loaded from its directory match transformers' forward in
    float32."""
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.BertConfig(
        vocab_size=len(WP_VOCAB), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
        type_vocab_size=2, hidden_act="gelu", layer_norm_eps=1e-12,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, num_labels=1)
    torch.manual_seed(0)
    bi = transformers.BertModel(hcfg).eval()
    ce = transformers.BertForSequenceClassification(hcfg).eval()
    spec = dict(vocab_size=len(WP_VOCAB), hidden_dim=32, num_layers=2, num_heads=4,
                mlp_dim=64, max_position=64)
    jcfg, tcfg = jb.BertConfig(dtype=jnp.float32, **spec), tb.BertConfig(
        dtype=torch.float32, **spec)
    sd = bi.state_dict()
    got = tm.convert_hf_bert(sd, tcfg)
    want = jm.convert_hf_bert({k: v.numpy() for k, v in sd.items()}, jcfg)
    for k, v in flatten_dict(want).items():
        np.testing.assert_array_equal(flatten_dict(got)[k], v)

    for sub, model in (("all-MiniLM-L6-v2", bi), ("ms-marco-MiniLM-L-6-v2", ce)):
        d = tmp_path / sub
        d.mkdir()
        torch.save(model.state_dict(), d / "pytorch_model.bin")
        (d / "vocab.txt").write_text("\n".join(WP_VOCAB) + "\n", encoding="utf-8")
    texts = ["the quick brown fox jumps over the lazy dog.", "dog!", "hybrid search"]
    enc = tm.MiniLMEncoder(dim=32, cfg=tcfg, checkpoint=str(tmp_path / "all-MiniLM-L6-v2"),
                           device=CPU)
    assert enc.weights_origin == "hf"
    ids, mask = enc.tokenizer.batch_encode(texts, 64)
    with torch.no_grad():
        out = bi(input_ids=torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long()).last_hidden_state
        m = torch.from_numpy(mask).float()[..., None]
        ref = (out * m).sum(1) / m.sum(1)
        ref = ref / ref.norm(dim=-1, keepdim=True)
    np.testing.assert_allclose(enc.encode(texts).numpy(), ref.numpy(), rtol=0, atol=F32_ABS)

    cross = tm.MiniLMCrossEncoder(cfg=tcfg, checkpoint=str(tmp_path / "ms-marco-MiniLM-L-6-v2"),
                                  device=CPU)
    pairs = [(texts[0], texts[1]), (texts[2], texts[0])]
    ids, types, mask = cross.tokenizer.batch_encode_pairs(pairs, 64)
    with torch.no_grad():
        ref = ce(input_ids=torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long(),
                 token_type_ids=torch.from_numpy(types).long()).logits[:, 0]
    np.testing.assert_allclose(cross.predict(pairs).numpy(), ref.numpy(), rtol=0, atol=F32_ABS)


# -- the byte-trigram encoder ------------------------------------------------------------

def test_byte_trigram_encoder_matches_jax():
    texts = ["Hello  World", "", "ab", "中文搜索 engine", "x" * 700,
             "the the the"]
    j = jenc.ByteTrigramEncoder(dim=32, n_buckets=1 << 10)
    t = tenc.ByteTrigramEncoder(dim=32, n_buckets=1 << 10, device=CPU)
    ids, ws = t.features(texts)
    for i, text in enumerate(texts):
        jids, jws = j._feature_arrays(text)
        n = len(jids)
        np.testing.assert_array_equal(ids[i, :n], jids)
        np.testing.assert_array_equal(ws[i, :n], jws)
        assert not ws[i, n:].any()
    t.table = torch.from_numpy(np.array(j.table))
    np.testing.assert_allclose(t.encode(texts).numpy(), j.encode(texts), rtol=1e-5, atol=1e-6)


# -- the rerankers ----------------------------------------------------------------------

def _same_ranking(got, want, tol):
    assert len(got) == len(want)
    np.testing.assert_allclose([s for s, _c, _i in got], [s for s, _c, _i in want],
                               rtol=0, atol=tol)
    ws = np.array([s for s, _c, _i in want])
    for j, (g, w) in enumerate(zip(got, want)):
        if g[2] != w[2]:
            assert (np.abs(ws - ws[j]) <= 2 * tol).sum() > 1, f"slot {j} outside a tie"


def test_rerankers_match_jax():
    results = [(0.9 - 0.05 * i, text, 100 + i) for i, text in enumerate(TEXTS[:5] * 2)]
    query = "quick fox search"
    jce = jrr.CrossEncoderReranker(model=jm.MiniLMCrossEncoder(checkpoint=CE_CKPT))
    tce = trr.CrossEncoderReranker(model=tm.MiniLMCrossEncoder(checkpoint=CE_CKPT, device=CPU))
    _same_ranking(tce.rerank(query, results, top_k=6), jce.rerank(query, results, top_k=6),
                  BF16_LOGIT_ABS)
    _same_ranking(tce.rerank_with_fusion(query, results), jce.rerank_with_fusion(query, results),
                  0.05)
    assert tce.rerank(query, []) == [] and tce.rerank_with_fusion(query, []) == []

    je, te = _carried_tiny_encoder()
    jli = jrr.LateInteractionReranker(encoder=je)
    tli = trr.create_reranker("colbert", encoder=te)
    _same_ranking(tli.rerank(query, results, top_k=7), jli.rerank(query, results, top_k=7),
                  F32_ABS)
    assert isinstance(trr.create_reranker("late_interaction", encoder=te),
                      trr.LateInteractionReranker)
    with pytest.raises(ValueError):
        trr.create_reranker("nope")
    np.testing.assert_array_equal(trr._minmax(np.array([2.0, 2.0])), [1.0, 1.0])


# -- search_batch with a transformer encoder ---------------------------------------------

@pytest.mark.parametrize("at_scale", [False, True])
def test_search_batch_with_a_carried_minilm_encoder_matches_jax(monkeypatch, at_scale):
    """The port's Indexer.index_documents + Searcher.search_batch with a tiny
    float32 MiniLMEncoder carrying the JAX encoder's weights, against the
    JAX searcher on the same corpus: below the at-scale threshold (the
    [B, n] program) and above it (the impact ladder on layout="source")."""
    from hybridsearch_tpu.retrieval import searcher as jsm
    from hybridsearch_tpu_torch.retrieval import searcher as tsm

    rng = np.random.default_rng(6)
    vocab = [f"w{i}" for i in range(200)]
    topics = [" ".join(f"z{z}t{j}" for j in range(6)) for z in range(6)]
    texts = [f"{topics[i % 6]} " + " ".join(rng.choice(vocab, size=10)) for i in range(600)]
    if at_scale:
        monkeypatch.setattr(jsm, "SPARSE_HYBRID_MIN_DOCS", 100)
        monkeypatch.setattr(tsm, "SPARSE_HYBRID_MIN_DOCS", 100)
    je, te = _carried_tiny_encoder()
    js = jsm.Searcher(encoder=je, use_query_memory=False)
    js.indexer.index_documents(texts)
    ts = tsm.Searcher(encoder=te, use_query_memory=False, device=CPU)
    ts.indexer.index_documents(texts)
    np.testing.assert_allclose(ts.indexer.dense._snap.docs.numpy()[:600],
                               np.asarray(js.indexer.dense._snap.docs)[:600], rtol=0,
                               atol=F32_ABS)
    queries = ["z2t1 z2t3 w7", "z4t0 z4t5", "w3 w11 w42", "z0t5", "nothing matches"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = js.search_batch(queries, top_k=5, log=False)
        got = ts.search_batch(queries, top_k=5, log=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_ranking(g, w, F32_ABS)


# -- encoder resolution ------------------------------------------------------------------

def _describe(enc):
    return (type(enc).__name__, getattr(enc, "weights_origin", None), enc.dim,
            getattr(getattr(enc, "cfg", None), "num_layers", None))


@pytest.mark.parametrize("kind", ["hashing", "minilm", "auto"])
@pytest.mark.parametrize("discovery", ["0", "1"])
def test_indexer_default_encoder_resolves_as_jax(monkeypatch, tmp_path, kind, discovery):
    """No HST_MODEL_DIR and an empty HOME: both packages' Indexer() find the
    same encoder (./models promotes hst-bi-v3 when discovery is on)."""
    from hybridsearch_tpu.index.builder import Indexer as JIndexer
    from hybridsearch_tpu_torch.index.builder import Indexer

    monkeypatch.chdir(REPO)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("HST_MODEL_DIR", raising=False)
    monkeypatch.setenv("HST_ENCODER", kind)
    monkeypatch.setenv("HST_CKPT_DISCOVERY", discovery)
    got = Indexer(device=CPU).encoder
    want = JIndexer().encoder
    assert _describe(got) == _describe(want)
    if discovery == "1" and kind != "hashing":
        assert got.checkpoint == os.path.join(".", "models", "hst-bi-v3")
        assert got.weights_origin == "in-repo-trained"
    assert got.device == CPU


def _tiny_checkpoint(path, cfg=None):
    cfg = cfg or tb.BertConfig(vocab_size=512, hidden_dim=64, num_layers=1, num_heads=2,
                               mlp_dim=128, max_position=64)
    model = tb.BiEncoder(cfg)
    tb.init_params(model, torch.Generator().manual_seed(0))
    tm.save_trained_checkpoint(model, cfg, str(path))
    return str(path)


def test_default_encoder_resolution_gates(tmp_path, monkeypatch):
    """R1's expectations (tests/test_models.py): HST_ENCODER pins the kind;
    auto serves a discovered checkpoint only at its own width, and an
    explicit HST_MODEL_DIR beats the repo's promotion."""
    monkeypatch.chdir(REPO)
    ckpt = _tiny_checkpoint(tmp_path / "hst-MiniLM-g")
    monkeypatch.setenv("HST_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("HST_CKPT_DISCOVERY", "1")
    monkeypatch.setenv("HST_ENCODER", "auto")
    enc = tenc.default_encoder(dim=64, device=CPU)
    assert isinstance(enc, tm.MiniLMEncoder) and enc.pretrained and enc.checkpoint == ckpt
    with pytest.warns(UserWarning, match="64 wide"):
        assert isinstance(tenc.default_encoder(dim=384, device=CPU), tenc.HashingEncoder)
    monkeypatch.setenv("HST_ENCODER", "hashing")
    assert isinstance(tenc.default_encoder(dim=64, device=CPU), tenc.HashingEncoder)


def test_find_checkpoint_discovers_model_dir(tmp_path, monkeypatch):
    """R1's second expectation (tests/test_hf_conversion.py): an HF-layout
    dir under HST_MODEL_DIR is found before ./models' promotion."""
    monkeypatch.chdir(REPO)
    d = tmp_path / "all-MiniLM-L6-v2"
    d.mkdir()
    torch.save({"w": torch.zeros(1)}, d / "pytorch_model.bin")
    monkeypatch.setenv("HST_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("HST_CKPT_DISCOVERY", "1")
    assert tm.find_checkpoint("all-MiniLM-L6-v2") == str(d)
    assert tm.find_checkpoint("no-such-model") is None
    # with nothing under HST_MODEL_DIR, the repo's promotion still serves
    monkeypatch.setenv("HST_MODEL_DIR", str(tmp_path / "empty"))
    assert tm.find_checkpoint("MiniLM") == os.path.join(".", "models", "hst-bi-v3")
    assert tm.find_checkpoint("ms-marco") == os.path.join(
        ".", "models", "hst-ms-marco-MiniLM-L-6-v2-synth")
    # a promotion in HST_MODEL_DIR itself wins over its walk
    (tmp_path / "PROMOTED.json").write_text(json.dumps({"all-MiniLM-L6-v2": "best"}))
    best = _tiny_checkpoint(tmp_path / "best")
    monkeypatch.setenv("HST_MODEL_DIR", str(tmp_path))
    assert tm.find_checkpoint("MiniLM") == best
    monkeypatch.setenv("HST_CKPT_DISCOVERY", "0")
    assert tm.find_checkpoint("MiniLM") is None and not tm.weights_available()


def test_explicit_cfg_pins_architecture():
    cfg = tb.BertConfig(vocab_size=500, hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64)
    enc = tm.MiniLMEncoder(dim=32, cfg=cfg, max_seq_len=32, device=CPU)
    assert not enc.pretrained and enc.weights_origin == "random"
    assert enc.encode(["x"]).shape == (1, 32)


def test_a_discovered_checkpoint_that_fails_to_load_raises(tmp_path, monkeypatch):
    d = tmp_path / "hst-MiniLM-broken"
    _tiny_checkpoint(d)
    (d / "hst_params.npz").write_bytes(b"not an npz")
    monkeypatch.setenv("HST_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("HST_CKPT_DISCOVERY", "1")
    for kind in ("auto", "minilm"):
        monkeypatch.setenv("HST_ENCODER", kind)
        with pytest.raises(Exception):
            tenc.default_encoder(dim=64, device=CPU)


def test_models_default_to_the_card():
    """No device= means the card: on a host without one they raise."""
    if torch.cuda.is_available():
        assert tm.MiniLMEncoder(checkpoint=BI_CKPT).device.type == "cuda"
        return
    for make in (lambda: tm.MiniLMEncoder(checkpoint=BI_CKPT),
                 lambda: tm.MiniLMCrossEncoder(checkpoint=CE_CKPT),
                 lambda: tenc.default_encoder(kind="minilm")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
