"""The transformer trunk, bi-encoder and cross-encoder on the card.

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_models.py

The in-repo checkpoints (``models/hst-bi-v3``, the bi-encoder the repo
promotes, and ``models/hst-ms-marco-MiniLM-L-6-v2-synth``) are served in
their default bfloat16 activations and held against a float32 forward of
the same module on the card: cuBLAS may sum the bf16 products in other
orders than the CPU, so parity with the JAX package is held on the CPU
(``tests/test_torch_models.py``) and here the bound is the bf16 rounding
itself. Bounds: least cosine 0.999 and max-abs 0.02 between unit
embeddings, also between one text encoded alone and inside a batch of
others (another padded shape, so cuBLAS may pick another kernel); largest
0.5 and mean 0.05 absolute difference between cross-encoder logits (which
span about -1 to 5; measured by chip_smoke.py on 256 served pairs of
48-word docs on an H100: largest 0.243, mean 0.010).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BI_CKPT = os.path.join(REPO, "models", "hst-bi-v3")
CE_CKPT = os.path.join(REPO, "models", "hst-ms-marco-MiniLM-L-6-v2-synth")
EMB_COS, EMB_ABS, LOGIT_MAX, LOGIT_MEAN = 0.999, 0.02, 0.5, 0.05


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _texts(n, seed=0, words=(3, 60)):
    rng = np.random.default_rng(seed)
    vocab = [f"t{t}x{j}" for t in range(50) for j in range(12)] + [f"w{i}" for i in range(400)]
    return [" ".join(rng.choice(vocab, size=int(rng.integers(*words)))) for _ in range(n)]


def _float32_twin(model):
    """The same module and weights with float32 activations, on the card."""
    twin = type(model)(dataclasses.replace(model.cfg, dtype=torch.float32))
    twin.load_state_dict(model.state_dict())
    return twin.to(next(model.parameters()).device).eval()


def _precision_flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def test_gpu_bf16_trunk_against_its_float32_forward():
    _needs_card()
    from hybridsearch_tpu_torch.models.minilm import MiniLMEncoder

    enc = MiniLMEncoder(checkpoint=BI_CKPT, device="cuda")
    assert enc.weights_origin == "in-repo-trained" and enc.dim == 384
    ids, mask = enc.tokenizer.batch_encode(_texts(300), enc.max_seq_len)
    ids_t = torch.from_numpy(ids.astype(np.int64)).cuda()
    mask_t = torch.from_numpy(mask).cuda()
    flags = _precision_flags()
    with torch.inference_mode():
        got = enc.model(ids_t, mask_t)
        want = _float32_twin(enc.model)(ids_t, mask_t)
    assert _precision_flags() == flags  # the trunk sets no precision flag
    assert got.dtype == torch.float32
    assert float((got * want).sum(1).min()) >= EMB_COS
    assert float((got - want).abs().max()) <= EMB_ABS


def test_gpu_encode_and_predict_stay_on_the_card():
    _needs_card()
    from hybridsearch_tpu_torch.models.minilm import MiniLMCrossEncoder, MiniLMEncoder

    enc = MiniLMEncoder(checkpoint=BI_CKPT, device="cuda")
    texts = _texts(200, seed=1)
    out = enc.encode(texts)
    assert out.is_cuda and out.shape == (200, 384) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.norm(dim=1).cpu().numpy(), 1.0, atol=1e-5)
    assert all(p.is_cuda for p in enc.model.parameters())
    ce = MiniLMCrossEncoder(checkpoint=CE_CKPT, device="cuda")
    scores = ce.predict([(texts[i], texts[i + 1]) for i in range(50)])
    assert scores.is_cuda and scores.shape == (50,) and torch.isfinite(scores).all()
    assert all(p.is_cuda for p in ce.model.parameters())


def test_gpu_text_alone_and_inside_a_batch():
    _needs_card()
    from hybridsearch_tpu_torch.models.minilm import MiniLMEncoder

    enc = MiniLMEncoder(checkpoint=BI_CKPT, device="cuda")
    texts = _texts(150, seed=2)
    batch = enc.encode(texts)
    for i in (0, 77, 149):
        alone = enc.encode([texts[i]])[0]
        assert float((alone * batch[i]).sum()) >= EMB_COS
        assert float((alone - batch[i]).abs().max()) <= EMB_ABS


def test_gpu_cross_encoder_on_128_token_pairs():
    """Pairs that fill the checkpoint's 128 positions, against the float32
    forward of the same module."""
    _needs_card()
    from hybridsearch_tpu_torch.models.minilm import MiniLMCrossEncoder

    ce = MiniLMCrossEncoder(checkpoint=CE_CKPT, device="cuda")
    assert ce.max_seq_len == 128
    texts = _texts(64, seed=3, words=(90, 120))
    pairs = [(texts[i][:200], texts[i + 1]) for i in range(60)]
    ids, types, mask = ce.tokenizer.batch_encode_pairs(pairs, ce.max_seq_len)
    assert ids.shape[1] == 128 and mask.sum(1).max() == 128
    stats = {}
    got = ce.predict(pairs, stats=stats)
    assert stats["tokens_padded"] == 64 * 128
    with torch.inference_mode():
        want = _float32_twin(ce.model)(*(torch.from_numpy(a.astype(np.int64)).cuda()
                                         for a in (ids, mask, types)))
    diff = (got - want).abs()
    assert float(diff.max()) <= LOGIT_MAX and float(diff.mean()) <= LOGIT_MEAN
