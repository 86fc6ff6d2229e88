"""Language detection + multilingual embedding hooks.

Counterpart of ``hybridsearch_tpu/services/language.py``, host code copied
with the port's imports; ``langdetect`` is imported at first use, and the
multilingual encoder runs on ``device``.

Parity with the reference language module (reference language.py:34-225):
50-language support list, minimum-confidence detection, Unicode-range
script detection, batch detection, and a multilingual encoder hook
(paraphrase-multilingual-MiniLM-L12-v2 when real weights exist).

First-party detector (the reference wraps `langdetect`, absent here):
script detection by Unicode block ranges (reference language.py:140-168
does the same), within-script refiners (Cyrillic/Arabic-script/Devanagari
languages are told apart by distinctive code points; Japanese vs Chinese by
kana presence), and for Latin-script text a function-word profile scorer
plus diacritic signatures covering every Latin-script language in
SUPPORTED_LANGUAGES — the full 50+ list the reference gets from langdetect.
langdetect is still used transparently when importable.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from typing import Dict, List, Optional, Sequence, Tuple

from hybridsearch_tpu_torch.utils.device import DeviceLike

# optional dependency (reference language.py:10-15), imported at first use
LANGDETECT_AVAILABLE = importlib.util.find_spec("langdetect") is not None

SUPPORTED_LANGUAGES = [
    "af", "ar", "bg", "bn", "ca", "cs", "cy", "da", "de", "el", "en", "es",
    "et", "fa", "fi", "fr", "gu", "he", "hi", "hr", "hu", "id", "it", "ja",
    "kn", "ko", "lt", "lv", "mk", "ml", "mr", "ne", "nl", "no", "pa", "pl",
    "pt", "ro", "ru", "sk", "sl", "so", "sq", "sv", "sw", "ta", "te", "th",
    "tl", "tr", "uk", "ur", "vi", "zh",
]  # 50+ language codes (reference language.py:34-40)

_SCRIPT_RANGES: List[Tuple[int, int, str]] = [
    (0x0370, 0x03FF, "greek"),
    (0x0400, 0x04FF, "cyrillic"),
    (0x0530, 0x058F, "armenian"),
    (0x0590, 0x05FF, "hebrew"),
    (0x0600, 0x06FF, "arabic"),
    (0x0750, 0x077F, "arabic"),
    (0x0900, 0x097F, "devanagari"),
    (0x0980, 0x09FF, "bengali"),
    (0x0A00, 0x0A7F, "gurmukhi"),
    (0x0A80, 0x0AFF, "gujarati"),
    (0x0B00, 0x0B7F, "oriya"),
    (0x0B80, 0x0BFF, "tamil"),
    (0x0C00, 0x0C7F, "telugu"),
    (0x0C80, 0x0CFF, "kannada"),
    (0x0D00, 0x0D7F, "malayalam"),
    (0x0D80, 0x0DFF, "sinhala"),
    (0x0E00, 0x0E7F, "thai"),
    (0x0E80, 0x0EFF, "lao"),
    (0x10A0, 0x10FF, "georgian"),
    (0x1100, 0x11FF, "hangul"),
    (0x1200, 0x137F, "ethiopic"),
    (0x1780, 0x17FF, "khmer"),
    (0x3040, 0x309F, "hiragana"),
    (0x30A0, 0x30FF, "katakana"),
    (0x4E00, 0x9FFF, "cjk"),
    (0xAC00, 0xD7AF, "hangul"),
]

_SCRIPT_TO_LANG = {
    "cyrillic": "ru", "hebrew": "he", "arabic": "ar", "devanagari": "hi",
    "bengali": "bn", "thai": "th", "hangul": "ko", "hiragana": "ja",
    "katakana": "ja", "cjk": "zh", "greek": "el", "armenian": "hy",
    "gurmukhi": "pa", "gujarati": "gu", "oriya": "or", "tamil": "ta",
    "telugu": "te", "kannada": "kn", "malayalam": "ml", "sinhala": "si",
    "lao": "lo", "georgian": "ka", "ethiopic": "am", "khmer": "km",
}

# Within-script disambiguation: distinctive code points that only one
# language of the shared script uses (checked in order; first hit wins).
_SCRIPT_REFINERS: Dict[str, List[Tuple[str, str]]] = {
    "cyrillic": [
        ("іїєґ", "uk"),      # Ukrainian-only letters
        ("јќѓџљњ", "mk"),   # Macedonian (also Serbian ј/љ/њ — mk per list)
        ("ъщ", "bg"),        # frequent in Bulgarian, rare in Russian text
    ],
    "arabic": [
        ("پچژگ", "fa"),     # Persian-only letters
        ("ٹڈڑےہں", "ur"),  # Urdu-only letters
    ],
    "devanagari": [
        ("ळऱ", "mr"),        # Marathi retroflexes
    ],
}

# Function-word profiles for Latin-script languages (top function words).
_PROFILES: Dict[str, frozenset] = {
    "en": frozenset("the and of to in is that it was for with as his on be at by".split()),
    "es": frozenset("el la de que y en los del se las por un para con una su".split()),
    "fr": frozenset("le la de et les des en un du une que est pour dans qui".split()),
    "de": frozenset("der die und das von zu den mit sich auf ist im dem nicht ein".split()),
    "it": frozenset("il di che la e un a per in una sono del le si con non".split()),
    "pt": frozenset("o de a e que do da em um para com os no se na por".split()),
    "nl": frozenset("de het een en van in is dat op te zijn met voor aan er".split()),
    "sv": frozenset("och det att i en som på är av för med den till inte om".split()),
    "no": frozenset("og det er i en som på til av for med at han ikke den".split()),
    "da": frozenset("og det er i en som på til af for med at han ikke den".split()),
    "pl": frozenset("w i na z do nie to jest że się o jak po co za".split()),
    "tr": frozenset("bir ve bu da ne için ile olarak daha çok gibi ama en".split()),
    "id": frozenset("yang dan di dengan untuk dari pada ini itu adalah ke tidak".split()),
    "ca": frozenset("el la de i que a en per amb els una les és al del més".split()),
    "cs": frozenset("a se na je to že s z do o jak ale po už být v".split()),
    "sk": frozenset("a sa na je to že s z do o ako ale po už som v".split()),
    "sl": frozenset("je in se na za da so z v ki pa po ne bi tudi".split()),
    "hr": frozenset("je i u na se da su za s od ne koji kao ali što".split()),
    "ro": frozenset("și de la în a cu pe este un o care mai din nu pentru".split()),
    "hu": frozenset("a az és hogy nem is egy meg már csak volt ez ha mint van".split()),
    "fi": frozenset("ja on ei se että oli hän mutta kun niin myös ole sen joka".split()),
    "et": frozenset("ja on ei ta see et oli ka kui aga oma või nagu mis".split()),
    "lt": frozenset("ir yra tai kad į iš su bet kaip jis buvo o ne jo".split()),
    "lv": frozenset("un ir tas ka no ar par bet kā viņš bija vai ne tik".split()),
    "af": frozenset("die en van het is in nie dat op vir met aan was sy om".split()),
    "sq": frozenset("dhe të në e një për me nga si ka nuk është se më".split()),
    "cy": frozenset("y yn a i o ar ei yr am gan fod wedi mae bod".split()),
    "sw": frozenset("na ya wa kwa ni za katika la kuwa kama hii cha kwamba".split()),
    "so": frozenset("oo iyo ka in uu ay waa ku si loo aan la soo".split()),
    "tl": frozenset("ang ng sa na mga ay at para hindi ito kung siya ito".split()),
    "vi": frozenset("và của là có không được cho một người này trong đã các".split()),
}

# Diacritic/letter signatures: characters (nearly) unique to one Latin-script
# language — a strong vote when profiles tie on short texts.
_LATIN_SIGNATURES: List[Tuple[str, str]] = [
    ("ơưạảấầẩẫậắằẳẵặẹẻẽếềểễệỉịọỏốồổỗộớờởỡợụủứừửữựỳỵỷỹđ", "vi"),
    ("ățșţş", "ro"),
    ("őű", "hu"),
    ("ąęłńśźż", "pl"),
    ("řůě", "cs"),
    ("ľĺŕä", "sk"),
    ("āēīū", "lv"),
    ("ėųū", "lt"),
    ("õ", "et"),  # ä/ö/ü are shared with fi/sv/de; õ alone is distinctive
    ("ß", "de"),
    ("ğış", "tr"),
    ("ñ", "es"),
    ("ãõ", "pt"),
    ("ŵŷ", "cy"),
    ("ë", "sq"),
]


@dataclasses.dataclass
class DetectionResult:
    language: str
    confidence: float
    script: Optional[str] = None


def detect_script(text: str) -> Optional[str]:
    """Dominant non-Latin script by Unicode block counting (reference
    language.py:140-168)."""
    counts: Dict[str, int] = {}
    for ch in text:
        cp = ord(ch)
        for lo, hi, name in _SCRIPT_RANGES:
            if lo <= cp <= hi:
                counts[name] = counts.get(name, 0) + 1
                break
    if not counts:
        return None
    return max(counts.items(), key=lambda kv: kv[1])[0]


class LanguageDetector:
    """detect / detect_simple / detect_batch (reference language.py:66-138)."""

    def __init__(self, min_confidence: float = 0.5) -> None:
        self.min_confidence = min_confidence

    def detect(self, text: str) -> DetectionResult:
        text = (text or "").strip()
        if not text:
            return DetectionResult("unknown", 0.0)
        if LANGDETECT_AVAILABLE:
            try:
                import langdetect  # type: ignore

                langs = langdetect.detect_langs(text)
                if langs:
                    best = langs[0]
                    if best.prob >= self.min_confidence:
                        return DetectionResult(best.lang, float(best.prob),
                                               detect_script(text))
            except Exception:
                pass
        script = detect_script(text)
        if script is not None:
            lang = _SCRIPT_TO_LANG.get(script, "unknown")
            for chars, refined in _SCRIPT_REFINERS.get(script, []):
                if any(c in text for c in chars):
                    lang = refined
                    break
            if script == "cjk" and any(
                0x3040 <= ord(c) <= 0x30FF for c in text
            ):
                lang = "ja"  # kana present -> Japanese, not Chinese
            return DetectionResult(lang, 0.9, script)
        # Latin-script: function-word profiles + diacritic signatures.
        lower = text.lower()
        words = [w for w in lower.split() if w.isalpha()]
        if not words:
            return DetectionResult("unknown", 0.0)
        scores = {
            lang: sum(1 for w in words if w in prof) / len(words)
            for lang, prof in _PROFILES.items()
        }
        for chars, lang in _LATIN_SIGNATURES:
            hits = sum(1 for c in lower if c in chars)
            if hits:
                scores[lang] = scores.get(lang, 0.0) + min(0.4, 0.2 * hits)
        lang, score = max(scores.items(), key=lambda kv: kv[1])
        confidence = min(1.0, 2.5 * score)
        if confidence < self.min_confidence:
            return DetectionResult("unknown", confidence)
        return DetectionResult(lang, confidence)

    def detect_simple(self, text: str) -> str:
        return self.detect(text).language

    def detect_batch(self, texts: Sequence[str]) -> List[DetectionResult]:
        return [self.detect(t) for t in texts]


class MultilingualEmbedder:
    """Multilingual encoder (reference language.py:171-225): MiniLM with
    multilingual weights when a checkpoint exists, else the language-
    agnostic BYTE-TRIGRAM encoder — hashed UTF-8 byte trigrams work for
    every script (CJK/Arabic/Cyrillic/...), so non-English retrieval
    FUNCTIONS out of the box where the reference raises ImportError
    without sentence-transformers (language.py:187-188). Evaluated by
    evaluation/multilingual.py (same-language retrieval across 10
    languages + script detection)."""

    DEFAULT_NAME = "paraphrase-multilingual-MiniLM-L12-v2"

    def __init__(self, name: str = DEFAULT_NAME, dim: int = 384,
                 device: DeviceLike = None) -> None:
        self.name = name
        self.dim = dim
        self.device = device
        self._encoder = None

    @property
    def encoder(self):
        if self._encoder is None:
            from hybridsearch_tpu_torch.models.minilm import weights_available

            if weights_available(self.name):
                from hybridsearch_tpu_torch.models.minilm import MiniLMEncoder

                self._encoder = MiniLMEncoder(name=self.name, dim=self.dim,
                                              device=self.device)
            else:
                from hybridsearch_tpu_torch.models.encoder import (
                    ByteTrigramEncoder,
                )

                self._encoder = ByteTrigramEncoder(dim=self.dim, device=self.device)
        return self._encoder

    def encode(self, texts: Sequence[str], batch_size: int = 64):
        return self.encoder.encode(texts, batch_size=batch_size)
