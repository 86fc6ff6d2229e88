"""Bundled end-to-end demo — the framework's smoke test (the port of
``hybridsearch_tpu/demo.py``; ``run_demo(device=)`` runs on the card unless
the CPU is asked for).

Parity with the reference demo driver (reference main.py:25-222): 12 sample
documents, then four demos — basic hybrid search, feedback loop with
learned weights, the multi-stage funnel, and MMR diversity. Quality
expectation matching the reference: "machine learning and AI" surfaces the
ML/AI documents.
"""

from __future__ import annotations

SAMPLE_DOCS = [
    "Python is a versatile programming language used in data science.",
    "Machine learning models learn patterns from training data.",
    "The weather today is sunny with a light breeze.",
    "Deep learning uses neural networks with many layers.",
    "JavaScript runs in web browsers and on servers with Node.",
    "Cooking pasta requires boiling water and a pinch of salt.",
    "Artificial intelligence is transforming many industries.",
    "The stock market fluctuated sharply this quarter.",
    "Neural networks are inspired by biological brains.",
    "Gardening in spring brings colorful flowers to the yard.",
    "Natural language processing lets machines understand text.",
    "Basketball players train for agility and endurance.",
]


def demo_basic_search(searcher) -> None:
    print("\n=== basic hybrid search ===")
    for query in ("machine learning and AI", "cooking pasta"):
        print(f"\nquery: {query!r}")
        for rank, (score, content, doc_id) in enumerate(
            searcher.search(query, top_k=3), 1
        ):
            print(f"  {rank}. [{score:.4f}] (doc {doc_id}) {content}")


def demo_feedback_loop(searcher) -> None:
    print("\n=== feedback loop ===")
    for _ in range(10):
        searcher.search("neural networks", top_k=2,
                        semantic_weight=0.8, lexical_weight=0.2)
        searcher.log_feedback("neural networks", 8, 1)
    learned = searcher.query_memory.get_optimal_weights()
    print(f"learned weights after 10 positive ratings: {learned}")


def demo_multi_stage(device=None) -> None:
    print("\n=== multi-stage funnel (dense -> BM25 -> cross-encoder) ===")
    from hybridsearch_tpu_torch.models.bert import BertConfig
    from hybridsearch_tpu_torch.models.minilm import MiniLMCrossEncoder
    from hybridsearch_tpu_torch.pipelines import create_pipeline
    from hybridsearch_tpu_torch.retrieval.reranker import CrossEncoderReranker

    cfg = BertConfig(vocab_size=2000, hidden_dim=64, num_layers=2,
                     num_heads=4, mlp_dim=128)
    rr = CrossEncoderReranker(model=MiniLMCrossEncoder(cfg=cfg, dim=64,
                                                       max_seq_len=64,
                                                       device=device))
    p = create_pipeline("multi_stage", reranker=rr, stage1_k=8, stage2_k=4,
                        final_k=2, device=device)
    p.index(SAMPLE_DOCS)
    out = p.search("machine learning")
    for rank, (score, content, doc_id) in enumerate(out.results, 1):
        print(f"  {rank}. [{score:.4f}] (doc {doc_id}) {content}")


def demo_diversity(device=None) -> None:
    print("\n=== MMR diversity ===")
    from hybridsearch_tpu_torch.pipelines import create_pipeline

    p = create_pipeline("diversity", lambda_param=0.5, device=device)
    p.index(SAMPLE_DOCS)
    out = p.search("learning systems", top_k=4)
    for rank, (score, content, doc_id) in enumerate(out.results, 1):
        print(f"  {rank}. [{score:.4f}] (doc {doc_id}) {content}")


def run_demo(device=None) -> None:
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    print("indexing 12 sample documents...")
    searcher = Searcher(device=device)
    searcher.indexer.index_documents(SAMPLE_DOCS)
    demo_basic_search(searcher)
    demo_feedback_loop(searcher)
    demo_multi_stage(device)
    demo_diversity(device)
    print("\ndemo complete.")


if __name__ == "__main__":
    run_demo()
