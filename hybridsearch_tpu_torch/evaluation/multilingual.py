"""Multilingual retrieval + detection eval (the port of
``hybridsearch_tpu/evaluation/multilingual.py``; no download needed).

60 hand-authored (query, passage) pairs across 10 languages, all mixed
into ONE retrieval corpus — a query must find its own-language passage
among 59 distractors (5 of them same-language). Exercises:

  * the unicode tokenizer (text/extractor.py: accented Latin, Cyrillic,
    CJK character bigrams) through BM25,
  * the language-agnostic byte-trigram embedder
    (models/encoder.py ByteTrigramEncoder / services/language.py),
  * script/language detection (services/language.py LanguageDetector).

The reference's multilingual story (language.py:171-225) is a
sentence-transformers wrapper that raises without external weights and
was never evaluated; this measures what actually ships.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from hybridsearch_tpu_torch.evaluation.metrics import host_array

# (language code, query, relevant passage)
PAIRS: List[Tuple[str, str, str]] = [
    # Spanish
    ("es", "entrenamiento de redes neuronales",
     "las redes neuronales se entrenan ajustando los pesos con descenso "
     "de gradiente"),
    ("es", "receta de paella valenciana",
     "la paella valenciana lleva arroz, azafrán, pollo y judía verde"),
    ("es", "previsión del tiempo lluvia",
     "la previsión anuncia lluvia fuerte y viento para el fin de semana"),
    ("es", "mercado de valores subida",
     "el mercado de valores subió tras los buenos resultados "
     "trimestrales"),
    ("es", "entrenamiento para maratón",
     "para preparar un maratón conviene aumentar los kilómetros "
     "semanales poco a poco"),
    ("es", "museo de arte moderno",
     "el museo de arte moderno inaugura una sala dedicada a la "
     "escultura"),
    # French
    ("fr", "apprentissage automatique des modèles",
     "les modèles d'apprentissage automatique apprennent à partir des "
     "données d'entraînement"),
    ("fr", "recette de ratatouille provençale",
     "la ratatouille provençale mijote aubergines, courgettes et "
     "tomates à feu doux"),
    ("fr", "grève des transports parisiens",
     "la grève des transports perturbe le métro et les bus parisiens"),
    ("fr", "taux d'intérêt banque centrale",
     "la banque centrale relève ses taux d'intérêt pour contenir "
     "l'inflation"),
    ("fr", "randonnée dans les alpes",
     "la randonnée alpine exige de bonnes chaussures et un départ "
     "matinal"),
    ("fr", "restauration des vitraux",
     "les artisans restaurent les vitraux anciens de la cathédrale"),
    # German
    ("de", "training neuronaler netze",
     "neuronale netze werden durch gradientenabstieg auf "
     "trainingsdaten trainiert"),
    ("de", "rezept für sauerteigbrot",
     "sauerteigbrot braucht einen reifen starter und lange gehzeiten"),
    ("de", "verspätung der deutschen bahn",
     "die bahn meldet verspätungen wegen bauarbeiten an der strecke"),
    ("de", "mietpreise in berlin",
     "die mietpreise in berlin steigen trotz neuer regulierung weiter"),
    ("de", "wandern im schwarzwald",
     "der schwarzwald bietet schattige wanderwege und ausblicke über "
     "die täler"),
    ("de", "energiewende und solaranlagen",
     "die energiewende treibt den ausbau von solaranlagen auf "
     "hausdächern voran"),
    # Italian
    ("it", "addestramento di reti neurali",
     "le reti neurali si addestrano aggiornando i pesi con la discesa "
     "del gradiente"),
    ("it", "ricetta della carbonara",
     "la carbonara vuole guanciale, pecorino, uova e niente panna"),
    ("it", "sciopero dei treni regionali",
     "lo sciopero ferma i treni regionali per tutta la giornata"),
    ("it", "restauro degli affreschi",
     "i restauratori puliscono gli affreschi rinascimentali della "
     "cappella"),
    ("it", "mercato immobiliare milano",
     "a milano i prezzi delle case continuano a salire in centro"),
    ("it", "allenamento per la maratona",
     "per la maratona serve aumentare gradualmente i chilometri "
     "settimanali"),
    # Portuguese
    ("pt", "treinamento de redes neurais",
     "as redes neurais são treinadas ajustando pesos por gradiente"),
    ("pt", "receita de feijoada completa",
     "a feijoada completa leva feijão preto, carnes defumadas e couve"),
    ("pt", "previsão de chuva no litoral",
     "a previsão indica chuva forte no litoral durante a semana"),
    ("pt", "alta do mercado de ações",
     "o mercado de ações subiu após o balanço trimestral das empresas"),
    ("pt", "trilha na serra do mar",
     "a trilha na serra exige bota impermeável e saída ao amanhecer"),
    ("pt", "museu do futebol",
     "o museu do futebol reabre com acervo ampliado de camisas "
     "históricas"),
    # Russian
    ("ru", "обучение нейронных сетей",
     "нейронные сети обучаются градиентным спуском на обучающих "
     "данных"),
    ("ru", "рецепт борща со сметаной",
     "борщ варят со свёклой, капустой и подают со сметаной"),
    ("ru", "задержки поездов метро",
     "в метро задержки поездов из-за ремонта на линии"),
    ("ru", "рост фондового рынка",
     "фондовый рынок вырос после сильной квартальной отчётности"),
    ("ru", "поход в горы с палаткой",
     "в горный поход берут палатку, тёплый спальник и запас воды"),
    ("ru", "реставрация старинных икон",
     "мастера реставрируют старинные иконы, укрепляя красочный слой"),
    # Chinese
    ("zh", "神经网络训练方法",
     "神经网络通过梯度下降在训练数据上学习权重"),
    ("zh", "北京烤鸭的做法",
     "北京烤鸭皮脆肉嫩，配薄饼和甜面酱一起吃"),
    ("zh", "地铁列车晚点",
     "由于线路检修，地铁列车出现晚点"),
    ("zh", "股票市场上涨",
     "财报超出预期后股票市场明显上涨"),
    ("zh", "登山需要准备什么",
     "登山要带好登山鞋、雨衣和充足的饮用水"),
    ("zh", "博物馆新展览",
     "博物馆推出青铜器新展览，展期三个月"),
    # Japanese
    ("ja", "ニューラルネットワークの学習",
     "ニューラルネットワークは勾配降下法で学習データから重みを学ぶ"),
    ("ja", "ラーメンの作り方",
     "ラーメンはスープと麺と具材のバランスが決め手になる"),
    ("ja", "電車の遅延情報",
     "線路工事の影響で電車に遅延が発生している"),
    ("ja", "株式市場の上昇",
     "決算発表の後で株式市場は大きく上昇した"),
    ("ja", "登山の持ち物リスト",
     "登山には登山靴と雨具と十分な水を持っていく"),
    ("ja", "美術館の新しい展示",
     "美術館では浮世絵の新しい展示が始まった"),
    # Arabic
    ("ar", "تدريب الشبكات العصبية",
     "تتعلم الشبكات العصبية الأوزان من بيانات التدريب بالانحدار "
     "التدريجي"),
    ("ar", "طريقة تحضير الكسكس",
     "يُطهى الكسكس على البخار ويقدم مع الخضار واللحم"),
    ("ar", "تأخر القطارات اليوم",
     "تأخرت القطارات بسبب أعمال الصيانة على الخط"),
    ("ar", "ارتفاع سوق الأسهم",
     "ارتفع سوق الأسهم بعد نتائج الأرباح الفصلية القوية"),
    ("ar", "رحلة تسلق الجبال",
     "يحتاج تسلق الجبال إلى حذاء مناسب وماء كاف"),
    ("ar", "معرض المتحف الجديد",
     "افتتح المتحف معرضا جديدا للمخطوطات النادرة"),
    # Hindi
    ("hi", "न्यूरल नेटवर्क का प्रशिक्षण",
     "न्यूरल नेटवर्क प्रशिक्षण डेटा पर ग्रेडिएंट डिसेंट से वज़न सीखता है"),
    ("hi", "दाल मखनी बनाने की विधि",
     "दाल मखनी धीमी आंच पर मक्खन और क्रीम के साथ पकती है"),
    ("hi", "ट्रेन देरी की सूचना",
     "पटरी की मरम्मत के कारण ट्रेनें देरी से चल रही हैं"),
    ("hi", "शेयर बाजार में तेजी",
     "तिमाही नतीजों के बाद शेयर बाजार में तेजी आई"),
    ("hi", "पहाड़ की चढ़ाई की तैयारी",
     "पहाड़ चढ़ने के लिए अच्छे जूते और पर्याप्त पानी चाहिए"),
    ("hi", "संग्रहालय की नई प्रदर्शनी",
     "संग्रहालय में पुरानी पांडुलिपियों की नई प्रदर्शनी लगी है"),
]


def eval_retrieval(encode_fn=None, device=None) -> Dict[str, object]:
    """Same-language retrieval over the mixed 60-passage corpus.
    encode_fn defaults to the MultilingualEmbedder fallback
    (ByteTrigramEncoder) on ``device``. Reports p@1 / mrr@10 overall and
    per language."""
    import numpy as np

    if encode_fn is None:
        from hybridsearch_tpu_torch.services.language import MultilingualEmbedder

        emb = MultilingualEmbedder(device=device)
        encode_fn = emb.encoder.encode
    docs = [d for _l, _q, d in PAIRS]
    queries = [q for _l, q, _d in PAIRS]
    langs = [lang for lang, _q, _d in PAIRS]
    dv = host_array(encode_fn(docs))
    qv = host_array(encode_fn(queries))
    dv /= np.maximum(np.linalg.norm(dv, axis=1, keepdims=True), 1e-9)
    qv /= np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-9)
    order = np.argsort(-(qv @ dv.T), axis=1)[:, :10]
    return _report(order, langs)


def eval_bm25(device=None) -> Dict[str, object]:
    """BM25 (on ``device``) over the same corpus — exercises the unicode
    tokenizer's accent handling and CJK bigrams end-to-end."""
    import numpy as np

    from hybridsearch_tpu_torch.index.sparse_index import BM25
    from hybridsearch_tpu_torch.text.extractor import extract_tokens

    docs = [d for _l, _q, d in PAIRS]
    langs = [lang for lang, _q, _d in PAIRS]
    bm = BM25(device=device)
    bm.fit_tokens([extract_tokens(d) for d in docs])
    order = np.stack([
        np.argsort(-np.asarray(bm.score_all(q)))[:10]
        for _l, q, _d in PAIRS
    ])
    return _report(order, langs)


def _report(order, langs) -> Dict[str, object]:
    import numpy as np

    gold = np.arange(len(langs))
    p1 = float(np.mean(order[:, 0] == gold))
    rr = []
    for i in range(len(langs)):
        hits = np.where(order[i] == i)[0]
        rr.append(1.0 / (1 + int(hits[0])) if len(hits) else 0.0)
    per_lang = {}
    for lang in sorted(set(langs)):
        idx = [i for i, l_ in enumerate(langs) if l_ == lang]
        per_lang[lang] = round(float(np.mean(
            order[idx, 0] == gold[idx])), 3)
    return {"p_at_1": round(p1, 4),
            "mrr_at_10": round(float(np.mean(rr)), 4),
            "n_queries": len(langs), "p_at_1_by_lang": per_lang}


def eval_detection() -> Dict[str, object]:
    """LanguageDetector accuracy over the passages (script-level match:
    the detector's 50-language output is mapped onto this eval's 10)."""
    from hybridsearch_tpu_torch.services.language import LanguageDetector

    det = LanguageDetector()
    ok = 0
    by_lang: Dict[str, int] = {}
    n_by_lang: Dict[str, int] = {}
    for lang, _q, d in PAIRS:
        got = det.detect(d).language
        n_by_lang[lang] = n_by_lang.get(lang, 0) + 1
        if got == lang:
            ok += 1
            by_lang[lang] = by_lang.get(lang, 0) + 1
    return {
        "accuracy": round(ok / len(PAIRS), 4),
        "n": len(PAIRS),
        "by_lang": {lang: round(by_lang.get(lang, 0) / n, 3)
                    for lang, n in n_by_lang.items()},
    }
