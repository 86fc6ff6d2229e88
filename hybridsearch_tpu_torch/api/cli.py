"""Command-line interface (the port of ``hybridsearch_tpu/api/cli.py``).

Parity with the reference CLI (reference cli.py:26-240): the 7 subcommands
search / index / add / stats / export / import / serve, plus demo.
`python -m hybridsearch_tpu_torch <cmd>` (see hybridsearch_tpu_torch/__main__.py).
``--device`` (default ``cuda``) places the index and the encoder; pass
``--device cpu`` on a host without a card. The port has no benchmark of
its own yet, so it has no ``bench`` subcommand.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _build_searcher(args):
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    s = Searcher(db_path=args.db, device=args.device)
    s.indexer.reload()
    return s


def cmd_search(args) -> int:
    s = _build_searcher(args)
    if not s.indexer.contents:
        print("index is empty — run `index` first", file=sys.stderr)
        return 1
    sw = args.semantic_weight
    lw = args.lexical_weight
    if sw is not None and lw is None:
        lw = 1.0 - sw  # reference cli.py:41-42
    results = s.search(args.query, top_k=args.top_k,
                       semantic_weight=sw, lexical_weight=lw,
                       use_learned_weights=args.learned)
    if args.json:
        # reference cli.py:46-48 JSON shape
        print(json.dumps([
            {"score": float(sc), "content": c, "doc_id": int(d)}
            for sc, c, d in results
        ], indent=2))
        return 0
    for rank, (score, content, doc_id) in enumerate(results, 1):
        preview = content[:120].replace("\n", " ")
        print(f"{rank:2d}. [{score:.4f}] (doc {doc_id}) {preview}")
    return 0


def _collect_path(path: str, extensions) -> List[tuple]:
    """[(path, content)] from a file OR a directory (the reference's
    index/add commands accept either, cli.py:61-105)."""
    import os

    from hybridsearch_tpu_torch.text.extractor import (discover_documents,
                                                 load_file_content)

    if os.path.isdir(path):
        return discover_documents(path, extensions)
    if os.path.isfile(path):
        content = load_file_content(path)
        return [(path, content)] if content else []
    return []


def cmd_index(args) -> int:
    from hybridsearch_tpu_torch.index.builder import Indexer

    with Indexer(db_path=args.db, device=args.device) as ix:
        docs = _collect_path(args.path, args.extensions)
        if not docs:
            print(f"no supported documents at {args.path}", file=sys.stderr)
            return 1
        stats = ix.index_documents([c for _p, c in docs], [p for p, _c in docs])
        if args.save:
            ix.save(args.save)
        print(f"indexed {stats['indexed']} documents from {args.path}")
    return 0


def cmd_add(args) -> int:
    from hybridsearch_tpu_torch.index.builder import Indexer

    with Indexer(db_path=args.db, device=args.device) as ix:
        ix.reload()
        texts: List[str] = []
        paths: List[str] = []
        if args.path:
            for p, c in _collect_path(args.path, args.extensions):
                texts.append(c)
                paths.append(p)
        if args.text:
            texts.append(args.text)
            paths.append("")
        if args.file:
            from hybridsearch_tpu_torch.text.extractor import load_file_content

            content = load_file_content(args.file)
            if content:
                texts.append(content)
                paths.append(args.file)
        if not texts:
            print("nothing to add (pass a path, --text or --file)",
                  file=sys.stderr)
            return 1
        ids = ix.add_documents(texts, paths=paths)
        print(f"added doc ids: {ids}")
    return 0


def cmd_stats(args) -> int:
    s = _build_searcher(args)
    stats = s.get_stats()
    # reference cli.py:106-126: a readable block, then JSON on --json
    print("\n=== Search Engine Statistics ===\n")
    print(f"Documents indexed: {stats.get('total_documents', 0)}")
    print(f"Total queries: {stats.get('total_queries', 0)}")
    print(f"Unique queries: {stats.get('unique_queries', 0)}")
    print(f"Total feedback: {stats.get('total_feedback', 0)}")
    print(f"Avg relevance: {stats.get('avg_relevance', 'N/A')}")
    if args.json:
        print(json.dumps(stats, indent=2, default=str))
    return 0


def cmd_export(args) -> int:
    from hybridsearch_tpu_torch.index.builder import Indexer

    output = args.output_pos or args.output
    with Indexer(db_path=args.db, device=args.device) as ix:
        ix.reload()
        ix.export_json(output)
        print(f"exported {len(ix.contents)} documents to {output}")
    return 0


def cmd_import(args) -> int:
    from hybridsearch_tpu_torch.index.builder import Indexer

    inp = args.input_pos or args.input
    if not inp:
        print("an input file is required (-i/--input)", file=sys.stderr)
        return 1
    with Indexer(db_path=args.db, device=args.device) as ix:
        n = ix.import_json(inp)
        print(f"imported {n} documents from {inp}")
    return 0


def cmd_serve(args) -> int:
    from hybridsearch_tpu_torch.api.app import EngineState
    from hybridsearch_tpu_torch.api.httpd import serve

    state = EngineState(db_path=args.db, auth_enabled=args.auth,
                        device=args.device)
    n = state.indexer.reload()
    print(f"loaded {n} documents from {args.db}")
    if args.fastapi:
        try:
            import uvicorn

            from hybridsearch_tpu_torch.api.fastapi_app import create_app

            uvicorn.run(create_app(state), host=args.host, port=args.port)
            return 0
        except ImportError:
            print("fastapi/uvicorn not installed; using stdlib server",
                  file=sys.stderr)
    serve(state, host=args.host, port=args.port)
    return 0


def cmd_demo(args) -> int:
    from hybridsearch_tpu_torch.demo import run_demo

    run_demo(device=args.device)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="hybridsearch_tpu_torch",
        description="hybrid search engine on PyTorch and CUDA",
    )
    parser.add_argument("--db", default="hybridsearch.db",
                        help="sqlite docstore path")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the index and the encoder "
                             "(cuda, cuda:N or cpu)")
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    # flag spellings match the reference CLI (reference cli.py:186-222)
    p = sub.add_parser("search", help="query the index")
    p.add_argument("query")
    p.add_argument("-k", "--top-k", type=int, default=5)
    p.add_argument("-w", "--semantic-weight", type=float, default=None,
                   help="semantic weight (0-1); lexical = 1 - w")
    p.add_argument("--lexical-weight", type=float, default=None)
    p.add_argument("--learned", action="store_true",
                   help="use weights learned from feedback")
    p.add_argument("--json", action="store_true", help="JSON output")
    p.add_argument("--faiss", action="store_true",
                   help="compat no-op: the sharded dense index is the "
                        "FAISS equivalent and is always on")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("index", help="index a file or directory")
    p.add_argument("path", help="file or directory to index")
    p.add_argument("-e", "--extensions", nargs="+", default=None,
                   help="file extensions to include")
    p.add_argument("--faiss", action="store_true",
                   help="compat no-op (dense index is always built)")
    p.add_argument("--save", default=None, help="persist engine manifest dir")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("add", help="add to the existing index")
    p.add_argument("path", nargs="?", default=None,
                   help="file or directory to add")
    p.add_argument("-e", "--extensions", nargs="+", default=None)
    p.add_argument("--text", default=None, help="add a literal string")
    p.add_argument("--file", default=None, help="add one file")
    p.set_defaults(fn=cmd_add)

    p = sub.add_parser("stats", help="index + query statistics")
    p.add_argument("--json", action="store_true", help="JSON output")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("export", help="export docs+vectors to JSON")
    p.add_argument("output_pos", nargs="?", default=None,
                   metavar="output")
    p.add_argument("-o", "--output", default="index_export.json")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("import", help="import docs+vectors from JSON")
    p.add_argument("input_pos", nargs="?", default=None, metavar="input")
    p.add_argument("-i", "--input", default=None)
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("serve", help="start the REST API")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--reload", action="store_true",
                   help="compat no-op (uvicorn auto-reload flag)")
    p.add_argument("--auth", action="store_true", help="enforce API keys")
    p.add_argument("--fastapi", action="store_true",
                   help="prefer fastapi/uvicorn when installed")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("demo", help="run the bundled demo")
    p.set_defaults(fn=cmd_demo)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
