"""The port's host services (hybridsearch_tpu_torch/services/: auth,
autocomplete, dedup, jobs, language, metadata_filter, watcher) and the
extractor helpers they need, against the JAX package's, on the CPU.

Every case of tests/test_services.py for these services runs through both
packages on the same inputs; the outputs must be equal (MinHash
signatures, filter biases, suggestions, detections, statuses, job and
watcher outcomes), floats exactly where both compute them in the same
Python, and the multilingual fallback encoder (whose table is a
``jax.random`` draw, carried across) within 1e-6.
"""

import importlib
import os
import time

import numpy as np
import pytest
import torch


def both(module: str):
    """(the JAX package's module, the port's) of ``services.<module>``,
    ``text.<module>`` or any dotted path under the package."""
    return (importlib.import_module(f"hybridsearch_tpu.{module}"),
            importlib.import_module(f"hybridsearch_tpu_torch.{module}"))


# -- autocomplete -------------------------------------------------------------------


def test_trie_prefix_and_frequency():
    outs = []
    for ac in both("services.autocomplete"):
        t = ac.PrefixTrie()
        for w in ("machine learning", "machine learning", "machine vision"):
            t.insert(w)
        outs.append(t.search_prefix("machine"))
    assert outs[0] == outs[1]
    assert outs[1][0] == ("machine learning", 2) and ("machine vision", 1) in outs[1]


def test_trie_fuzzy():
    outs = []
    for ac in both("services.autocomplete"):
        t = ac.PrefixTrie()
        t.insert("python")
        outs.append(t.fuzzy_search("pythn", max_distance=2))
    assert outs[0] == outs[1] and outs[1][0][0] == "python"


def test_autocomplete_three_sources_and_learning(demo_docs):
    runs = []
    for ac in both("services.autocomplete"):
        e = ac.AutocompleteEngine()
        e.record_query("machine learning")
        e.index_content(demo_docs)
        first = e.suggest("mach")
        e.record_selection("machine learning")
        runs.append((first, e.suggest("mach"), e.suggest("machne learning")))
    (j1, j2, j3), (t1, t2, t3) = runs
    def rows(out):  # every field but latency_ms, a clock reading
        return [{k: v for k, v in s.items() if k != "latency_ms"} for s in out]

    assert [rows(x) for x in (t1, t2, t3)] == [rows(x) for x in (j1, j2, j3)]
    assert t1[0]["suggestion"] == "machine learning" and t2[0]["score"] > t1[0]["score"]
    assert any(s["source"] == "fuzzy" for s in t3)


# -- dedup ------------------------------------------------------------------------------


def test_minhash_shingle_hashes_equal_the_jax_ones():
    jn, tn = both("text.native")
    for text in ("hello world", "ab", "", "naïve café 東京 ok", "x" * 300):
        for k in (1, 3, 5):
            assert tn.minhash_shingle_hashes(text, k) == jn.minhash_shingle_hashes(text, k)


def test_minhash_similarity_tracks_jaccard():
    texts = ("the quick brown fox jumps over the lazy dog",
             "the quick brown fox jumps over the lazy cat",
             "completely unrelated text about quantum physics")
    sigs = []
    for dd in both("services.dedup"):
        h = dd.MinHasher()
        sigs.append([h.signature(t) for t in texts])
    for a, b in zip(*sigs):
        np.testing.assert_array_equal(a, b)
    h = both("services.dedup")[1].MinHasher()
    a, b, c = sigs[1]
    assert h.similarity(a, b) > 0.6 and h.similarity(a, c) < 0.3 and h.similarity(a, a) == 1


def test_dedup_exact_and_near(demo_docs):
    outs = []
    near = demo_docs[0].replace("data science", "data sciences")
    for dd in both("services.dedup"):
        e = dd.DeduplicationEngine(threshold=0.8)
        e.add_document("d0", demo_docs[0])
        outs.append((e.find_duplicates(demo_docs[0]), e.find_duplicates(near),
                     e.find_duplicates("entirely different content here")))
    assert outs[0] == outs[1]
    assert outs[1][0][0] == ("d0", 1.0) and outs[1][1][0][0] == "d0" and outs[1][2] == []


def test_dedup_check_and_handle_actions(demo_docs):
    outs = []
    for dd in both("services.dedup"):
        e = dd.DeduplicationEngine(threshold=0.8, action=dd.DedupeAction.SKIP)
        outs.append((e.check_and_handle("a", demo_docs[0]),
                     e.check_and_handle("b", demo_docs[0])))
    assert outs[0] == outs[1]
    assert outs[1][0]["is_duplicate"] is False and outs[1][1]["action"] == "skip"


def test_find_all_duplicates(demo_docs):
    outs = []
    for dd in both("services.dedup"):
        e = dd.DeduplicationEngine(threshold=0.8)
        outs.append(e.find_all_duplicates({"a": demo_docs[0], "b": demo_docs[0],
                                           "c": demo_docs[5]}))
    assert outs[0] == outs[1] and len(outs[1]) == 1 and outs[1][0]["key"] == "b"


# -- language -----------------------------------------------------------------------------

LANGUAGE_TEXTS = [
    "the cat sat on the mat and it was happy",
    "el gato se sentó en la alfombra y la casa es grande",
    "le chat est dans la maison et il est content",
    "это русский текст", "", "   ", "12345 !!!",
    "the cat is here and the dog is there", "das ist ein haus und der hund",
    "นี่คือข้อความภาษาไทย", "이것은 한국어 텍스트입니다", "これは日本語のテキストです",
    "漢字だけでなくひらがなもある", "这是中文文本没有假名", "זהו טקסט בעברית",
    "هذا نص باللغة العربية", "این متن فارسی است و دارای گچپژ", "یہ اردو میں ہے ڈاک ٹھیک",
    "यह हिंदी में पाठ है", "এটি বাংলা পাঠ্য", "இது தமிழ் உரை", "ఇది తెలుగు వచనం",
    "ಇದು ಕನ್ನಡ ಪಠ್ಯ", "ഇത് മലയാളം വാചകം", "આ ગુજરાતી લખાણ છે", "ਇਹ ਪੰਜਾਬੀ ਪਾਠ ਹੈ",
    "αυτό είναι ελληνικό κείμενο", "це український текст із літерою ї",
    "acesta este un text în limba română și are diacritice",
    "ez egy magyar szöveg és nagyon hosszú hogy biztos legyen",
    "tämä on suomenkielinen teksti ja se on pitkä että varma",
    "toto je český text a je to dlouhé že se pozná",
    "đây là văn bản tiếng việt của chúng tôi",
    "to jest polski tekst i jest długi że się pozna",
    "dit is een nederlandse tekst en het is lang",
    "detta är en svensk text och den är som lång",
    "bu bir türkçe metin ve çok uzun gibi ama en iyi",
    "ini adalah teks bahasa indonesia yang panjang untuk itu",
]


def test_detect_script_ranges():
    jl, tl = both("services.language")
    for text in LANGUAGE_TEXTS + ["plain english"]:
        assert tl.detect_script(text) == jl.detect_script(text), text
    assert tl.detect_script("это русский текст") == "cyrillic"


@pytest.mark.parametrize("min_confidence", [0.5, 0.9])
def test_language_detector_on_every_case(min_confidence):
    """The cases of the major-language, batch and breadth tests of
    tests/test_services.py: equal DetectionResults."""
    jl, tl = both("services.language")
    want = jl.LanguageDetector(min_confidence).detect_batch(LANGUAGE_TEXTS)
    got = tl.LanguageDetector(min_confidence).detect_batch(LANGUAGE_TEXTS)
    assert [(r.language, r.confidence, r.script) for r in got] == \
        [(r.language, r.confidence, r.script) for r in want]
    if min_confidence == 0.5:
        assert [r.language for r in got[:5]] == ["en", "es", "fr", "ru", "unknown"]


def test_language_support_lists_are_equal():
    jl, tl = both("services.language")
    assert tl.SUPPORTED_LANGUAGES == jl.SUPPORTED_LANGUAGES
    assert tl.LANGDETECT_AVAILABLE == jl.LANGDETECT_AVAILABLE


def test_multilingual_embedder_fallback(demo_docs):
    """Without multilingual weights the hook serves the byte-trigram
    encoder in both packages; with the JAX table carried across the
    embeddings agree."""
    jl, tl = both("services.language")
    jemb = jl.MultilingualEmbedder(dim=64)
    temb = tl.MultilingualEmbedder(dim=64, device="cpu")
    texts = ["hola mundo", "hello world", demo_docs[0]]
    want = jemb.encode(texts)
    assert type(temb.encoder).__name__ == type(jemb.encoder).__name__ == "ByteTrigramEncoder"
    temb.encoder.table = torch.from_numpy(np.array(jemb.encoder.table))
    got = temb.encode(texts, batch_size=2)
    assert got.shape == (3, 64) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(got, temb.encode(texts))


def test_hashing_encoder_takes_batch_size():
    """``encode(texts, batch_size=)`` (services/language.py passes it)
    returns the same rows whatever the batch size."""
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder

    enc = HashingEncoder(dim=32, device="cpu")
    texts = [f"doc {i} about topic {i % 3}" for i in range(10)]
    want = enc.encode(texts)
    for bs in (1, 3, 64):
        assert torch.equal(enc.encode(texts, batch_size=bs), want)


# -- metadata filter ------------------------------------------------------------------------


def _eval_all(mf, expr, records):
    node = mf.FilterParser().parse(expr)
    return [mf.evaluate(node, r) for r in records]


@pytest.mark.parametrize("expr,records", [
    ("category:science AND year:>2020",
     [{"category": "science", "year": 2021}, {"category": "science", "year": 2019},
      {"category": "art", "year": 2021}]),
    ("(category:a OR category:b) AND NOT flag:true",
     [{"category": "a", "flag": False}, {"category": "a", "flag": True},
      {"category": "c", "flag": False}]),
    ("title:~learn", [{"title": "Machine Learning"}, {"title": "cooking"}]),
    ("tag:in(a,b)", [{"tag": "b"}, {"tag": "c"}]),
    ("score:>=0.5", [{"score": 0.5}, {"score": 0.4}]),
    ("nested.key:v", [{"nested": {"key": "v"}}, {"nested": {}}]),
])
def test_filter_parser_and_eval(expr, records):
    jm, tm = both("services.metadata_filter")
    got = _eval_all(tm, expr, records)
    assert got == _eval_all(jm, expr, records)
    assert got[0] and not got[1]


def test_filter_parse_errors():
    for mf in both("services.metadata_filter"):
        for bad in ("AND AND", "(a:1"):
            with pytest.raises(mf.FilterParseError):
                mf.FilterParser().parse(bad)


def test_filter_to_sql_roundtrip(tmp_path):
    from hybridsearch_tpu_torch.store.docstore import DocStore

    jm, tm = both("services.metadata_filter")
    expr = "category:science AND year:>2019"
    sql, params = tm.to_sql(tm.FilterParser().parse(expr))
    assert (sql, params) == jm.to_sql(jm.FilterParser().parse(expr))
    store = DocStore(str(tmp_path / "m.db"))
    store.add_documents(["d0", "d1", "d2"])
    store.set_metadata(0, {"category": "science", "year": 2021})
    store.set_metadata(1, {"category": "art", "year": 2019})
    store.set_metadata(2, {"category": "science", "year": 2018})
    rows = store._conn.execute(f"SELECT doc_id FROM doc_metadata WHERE {sql}",
                               params).fetchall()
    assert [r["doc_id"] for r in rows] == [0]


def test_filter_to_bias_prefilter(tmp_path):
    """``to_bias`` returns what the JAX function returns (a float32 numpy
    vector), also through a store-backed engine's ``bias_for``."""
    from hybridsearch_tpu.store.docstore import DocStore as JDocStore
    from hybridsearch_tpu_torch.store.docstore import DocStore

    jm, tm = both("services.metadata_filter")
    meta = {0: {"keep": True}, 1: {"keep": False}, 2: {"keep": True}}
    got = tm.to_bias(tm.FilterParser().parse("keep:true"), meta, 4)
    want = jm.to_bias(jm.FilterParser().parse("keep:true"), meta, 4)
    assert type(got) is type(want) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and got[1] == -np.inf and got[3] == -np.inf
    biases = []
    for i, (mf, store_cls) in enumerate(((jm, JDocStore), (tm, DocStore))):
        store = store_cls(str(tmp_path / f"m{i}.db"))
        store.add_documents(["d0", "d1", "d2", "d3"])
        eng = mf.MetadataFilterEngine(store=store)
        for doc, m in meta.items():
            eng.set_metadata(doc, m)
        biases.append(eng.bias_for("keep:true", 4))
    np.testing.assert_array_equal(biases[1], biases[0])
    np.testing.assert_array_equal(biases[1], got)


def test_metadata_schema_validation():
    outs = []
    for mf in both("services.metadata_filter"):
        schema = mf.MetadataSchema([mf.FieldSpec("year", "int", required=True),
                                    mf.FieldSpec("tags", "list")])
        outs.append((schema.validate({"year": 2020, "tags": []}),
                     schema.validate({"tags": "no"})))
        with pytest.raises(ValueError):
            mf.MetadataFilterEngine(schema=schema).set_metadata(0, {"tags": []})
    assert outs[0] == outs[1] and outs[1][0] == [] and outs[1][1]


def test_metadata_engine_post_filter():
    results = [(0.9, "a", 0), (0.8, "b", 1)]
    meta = {0: {"lang": "en"}, 1: {"lang": "de"}}
    outs = [mf.MetadataFilterEngine().filter_results("lang:en", results, metadata=meta)
            for mf in both("services.metadata_filter")]
    assert outs[0] == outs[1] == [(0.9, "a", 0)]


# -- jobs -------------------------------------------------------------------------------------


def _wait(q, jid, state, tries=200):
    for _ in range(tries):
        if q.get(jid).state == state:
            break
        time.sleep(0.02)
    return q.get(jid)


def _job_view(job):
    return (job.state.value, job.result, job.progress, job.retries,
            None if job.error is None else job.error.splitlines()[-1])


def test_job_lifecycle_success():
    views = []
    for jb in both("services.jobs"):
        q = jb.JobQueue(n_workers=1)

        def handler(payload, progress_cb, cancel):
            progress_cb(50)
            return {"done": payload["x"] * 2}

        q.register_handler("double", handler)
        views.append(_job_view(_wait(q, q.enqueue("double", {"x": 21}),
                                     jb.JobState.COMPLETED)))
        q.shutdown()
    assert views[0] == views[1] == ("completed", {"done": 42}, 100.0, 0, None)


def test_job_retries_and_failures():
    views = []
    for jb in both("services.jobs"):
        q = jb.JobQueue(n_workers=1, retry_base_delay=0.01)
        attempts = {"n": 0}

        def flaky(payload, progress_cb, cancel):
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise RuntimeError("boom")
            return "ok"

        def always_fails(payload, progress_cb, cancel):
            raise ValueError("nope")

        q.register_handler("flaky", flaky)
        q.register_handler("bad", always_fails)
        ok = _job_view(_wait(q, q.enqueue("flaky", max_retries=3), jb.JobState.COMPLETED))
        bad = _job_view(_wait(q, q.enqueue("bad", max_retries=1), jb.JobState.FAILED))
        with pytest.raises(ValueError):
            q.enqueue("nope")
        views.append((ok, bad, attempts["n"]))
        q.shutdown()
    assert views[0] == views[1]
    assert views[1][0][:2] == ("completed", "ok") and views[1][0][3] == 2
    assert views[1][1][0] == "failed" and "nope" in views[1][1][4]


def test_job_cancellation():
    states = []
    for jb in both("services.jobs"):
        q = jb.JobQueue(n_workers=1)
        started = []

        def slow(payload, progress_cb, cancel):
            started.append(True)
            for _ in range(100):
                if cancel.is_set():
                    raise RuntimeError("cancelled mid-flight")
                time.sleep(0.01)
            return "done"

        q.register_handler("slow", slow)
        jid = q.enqueue("slow")
        for _ in range(100):
            if started:
                break
            time.sleep(0.01)
        assert q.cancel(jid)
        states.append(_wait(q, jid, jb.JobState.CANCELLED).state.value)
        q.shutdown()
    assert states == ["cancelled", "cancelled"]


# -- auth -----------------------------------------------------------------------------------------


def _auth_trace(auth):
    """Every decision of the tests/test_services.py auth cases, in order."""
    out = [auth.AuthContext(enabled=False).authorize(None, "1.2.3.4")[:2]]
    ctx = auth.AuthContext(enabled=True)
    key = ctx.keys.create_key("test", scopes={"read"})
    out += [ctx.authorize(key.key, "ip", scope="read")[:2],
            ctx.authorize(key.key, "ip", scope="write")[:2],
            ctx.authorize("bogus", "ip")[:2]]
    ctx.keys.revoke(key.key)
    out.append(ctx.authorize(key.key, "ip")[:2])
    ctx = auth.AuthContext(enabled=True, key_limit=2, ip_limit=100)
    key = ctx.keys.create_key("rl")
    out += [ctx.authorize(key.key, "ip")[:2] for _ in range(2)]
    ok, status, headers = ctx.authorize(key.key, "ip")
    out.append((ok, status, "Retry-After" in headers))
    ctx = auth.AuthContext(enabled=True, ip_limit=2)
    key = ctx.keys.create_key("k")
    out += [ctx.authorize(key.key, "9.9.9.9")[:2] for _ in range(3)]
    ctx = auth.AuthContext(enabled=True)
    key = ctx.keys.create_key("short", ttl_seconds=0.01)
    time.sleep(0.05)
    out.append(ctx.authorize(key.key, "ip")[:2])
    return out


def test_auth_decisions_match():
    jauth, tauth = both("services.auth")
    got = _auth_trace(tauth)
    assert got == _auth_trace(jauth)
    assert [s for *_o, s in got[:5]] == [200, 200, 403, 401, 401]
    assert got[7] == (False, 429, True) and got[10][1] == 429


# -- extractor helpers and the watcher ------------------------------------------------------------


def _tree_of_files(root):
    (root / "sub").mkdir()
    (root / "a.txt").write_text("  hello\n\n world  ")
    (root / "b.md").write_text("# Title\nbody text")
    (root / "sub" / "c.json").write_text('{"t": "json title", "k": ["x", {"y": "deep"}], "n": 3}')
    (root / "sub" / "bad.json").write_text("{not json")
    (root / "skip.bin").write_bytes(b"\x00\x01")
    (root / "empty.log").write_text("")
    (root / "UPPER.TXT").write_text("upper case extension")


def test_extractor_helpers_match(tmp_path):
    jx, tx = both("text.extractor")
    _tree_of_files(tmp_path)
    assert tx.SUPPORTED_EXTENSIONS == jx.SUPPORTED_EXTENSIONS
    assert tx.discover_documents(str(tmp_path)) == jx.discover_documents(str(tmp_path))
    assert tx.discover_documents(str(tmp_path), [".md"]) == \
        jx.discover_documents(str(tmp_path), [".md"])
    for name in ("a.txt", "sub/c.json", "sub/bad.json", "skip.bin", "empty.log",
                 "missing.txt"):
        p = str(tmp_path / name)
        assert tx.load_file_content(p) == jx.load_file_content(p), name
    for name in ("a.txt", "UPPER.TXT", "skip.bin"):
        p = str(tmp_path / name)
        assert tx.extract_metadata(p) == jx.extract_metadata(p), name
    assert tx.load_file_content(str(tmp_path / "sub/c.json")) == "json title\nx\ndeep"


def _watch(watcher_mod, root, script, **kw):
    events = []
    w = watcher_mod.FileWatcher(str(root),
                                lambda ev, p: events.append((ev, os.path.basename(p))),
                                **kw)
    w.start()
    try:
        time.sleep(0.15)
        script(root)
    finally:
        w.stop()
    return events


def _create_modify_delete(root):
    f = root / "doc.txt"
    f.write_text("hello")
    time.sleep(0.25)
    f.write_text("hello world")
    time.sleep(0.25)
    f.unlink()
    time.sleep(0.25)


def _write_ignored(root):
    (root / "ignore.bin").write_bytes(b"x")
    time.sleep(0.25)


@pytest.mark.parametrize("script,want", [(_create_modify_delete, {"created", "deleted"}),
                                         (_write_ignored, set())])
def test_polling_watcher_detects_changes(tmp_path, script, want):
    """The polling backend of both packages on the same changes: the same
    event kinds (created and deleted at least; none for an unwatched
    extension)."""
    kinds = []
    for i, wm in enumerate(both("services.watcher")):
        root = tmp_path / str(i)
        root.mkdir()
        wm_poll = _watch(wm, root, script, poll_interval=0.05, debounce=0.0)
        kinds.append({e for e, _n in wm_poll})
    assert kinds[0] == kinds[1] and want <= kinds[1]
    if not want:
        assert kinds[1] == set()


def test_watcher_trailing_edge_debounce(tmp_path):
    """The suppressed modify re-fires after the window in both packages."""
    for i, wm in enumerate(both("services.watcher")):
        root = tmp_path / str(i)
        root.mkdir()
        events = []
        w = wm.FileWatcher(str(root), lambda ev, p: events.append(time.time()),
                           poll_interval=0.05, debounce=0.3)
        w.start()
        try:
            time.sleep(0.15)
            f = root / "doc.txt"
            f.touch()
            deadline = time.time() + 2.0
            while not events and time.time() < deadline:
                time.sleep(0.02)
            f.write_text("real content")
            deadline = time.time() + 3.0
            while len(events) < 2 and time.time() < deadline:
                time.sleep(0.05)
        finally:
            w.stop()
        assert len(events) >= 2 and events[1] - events[0] >= 0.29, wm.__name__


def test_inotify_backend_detects_changes(tmp_path):
    import sys

    if not sys.platform.startswith("linux"):
        pytest.skip("inotify is Linux-only")
    jw, tw = both("services.watcher")
    assert tw.INOTIFY_AVAILABLE == jw.INOTIFY_AVAILABLE
    assert tw.WATCHDOG_AVAILABLE == jw.WATCHDOG_AVAILABLE

    def script(root):
        time.sleep(0.15)
        (root / "a.txt").write_text("hello")
        (root / "skip.bin").write_text("binary")
        sub = root / "sub"
        sub.mkdir()
        time.sleep(0.6)
        (sub / "b.md").write_text("nested")
        time.sleep(0.6)
        (root / "a.txt").unlink()
        time.sleep(0.8)

    names = []
    for i, wm in enumerate((jw, tw)):
        root = tmp_path / str(i)
        root.mkdir()
        ev = _watch(wm, root, script, poll_interval=99.0, debounce=0.0)
        names.append(({n for _e, n in ev}, ("deleted", "a.txt") in ev))
    assert names[0] == names[1] == ({"a.txt", "b.md"}, True)


def test_auto_indexer_reindexes_on_change(tmp_path):
    from hybridsearch_tpu.index.builder import Indexer as JIndexer
    from hybridsearch_tpu.models.encoder import HashingEncoder as JEnc
    from hybridsearch_tpu_torch.index.builder import Indexer
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder

    contents = []
    for i, (wm, ix) in enumerate(zip(both("services.watcher"), (
            JIndexer(encoder=JEnc(dim=64)),
            Indexer(encoder=HashingEncoder(dim=64, device="cpu"), device="cpu")))):
        root = tmp_path / str(i)
        root.mkdir()
        w = wm.create_auto_indexer(ix, str(root), poll_interval=0.05, debounce=0.0)
        w.start()
        try:
            time.sleep(0.15)
            (root / "a.txt").write_text("machine learning content here")
            for _ in range(80):
                if ix.dense.n_docs == 1:
                    break
                time.sleep(0.05)
        finally:
            w.stop()
        contents.append(list(ix.contents))
    assert contents[0] == contents[1] == ["machine learning content here"]


def test_services_import_no_optional_package():
    """Importing the port's services loads none of langdetect, watchdog or
    requests (each is imported where it is used)."""
    import subprocess
    import sys

    code = ("import sys; import hybridsearch_tpu_torch.services.jobs, "
            "hybridsearch_tpu_torch.services.language, "
            "hybridsearch_tpu_torch.services.watcher; "
            "print(sorted(m for m in ('langdetect', 'watchdog', 'requests', 'jax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("text", ["group:3", "NOT group:3", "group:>5 OR lang:en",
                                  "group:!=2", "NOT (lang:en AND group:<4)"])
def test_to_bias_over_sparse_metadata_equals_jax(text):
    """``to_bias`` judges a doc without metadata once (as ``{}``) and walks
    only the docs that carry some: the same bias as the JAX package's walk
    over every doc, for filters that pass or fail an empty record, with
    metadata on ids past ``n_docs`` ignored."""
    jm, tm = both("services.metadata_filter")
    rng = np.random.default_rng(3)
    meta = {int(i): {"group": int(rng.integers(0, 8)),
                     "lang": str(rng.choice(["en", "de"]))}
            for i in rng.choice(5000, 700, replace=False)}
    meta[7000] = {"group": 3, "lang": "en"}  # past n_docs
    want = jm.to_bias(jm.FilterParser().parse(text), meta, 5000)
    got = tm.to_bias(tm.FilterParser().parse(text), meta, 5000)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (5000,)
