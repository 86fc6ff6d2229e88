"""Metadata filtering: query language -> AST -> (eval | SQL | device mask).

Counterpart of ``hybridsearch_tpu/services/metadata_filter.py``, host code copied
with the port's imports.

Parity with the reference metadata module (reference metadata.py:25-412):
recursive-descent parser for `field:value` conditions with operators and
AND/OR/NOT/parentheses, per-doc AST evaluation, AST -> SQL compilation
(SQLite json_extract here instead of DuckDB JSON), typed schema validation,
and a store facade over the host DocStore.

TPU-native addition: `to_bias` compiles a filter to a 0/-inf score-bias
vector consumed by the dense kernel (ops/dense.py bias arg) — a
*pre*-filter inside the top-k kernel, unlike the reference's post-filter of
retrieved results (reference api.py:759-791).

Syntax:
    field:value            equality
    field:!=value          inequality
    field:>v  :>=v  :<v  :<=v   numeric comparison
    field:~substr          contains
    field:in(a,b,c)        membership
    combinators: AND, OR, NOT, parentheses
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

# -- AST --------------------------------------------------------------------------


@dataclasses.dataclass
class Condition:
    field: str
    op: str  # eq, ne, gt, gte, lt, lte, contains, in
    value: Any


@dataclasses.dataclass
class And:
    parts: List[Any]


@dataclasses.dataclass
class Or:
    parts: List[Any]


@dataclasses.dataclass
class Not:
    part: Any


Node = Union[Condition, And, Or, Not]


# -- parser (recursive descent, reference metadata.py:165-268) ----------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<lparen>\() | (?P<rparen>\)) |
        (?P<and>AND\b) | (?P<or>OR\b) | (?P<not>NOT\b) |
        (?P<cond>[A-Za-z_][\w.]*:(?:in\([^)]*\)|~?[^\s()]+))
    )""",
    re.VERBOSE | re.IGNORECASE,
)

_COND_RE = re.compile(
    r"^(?P<field>[A-Za-z_][\w.]*):(?:"
    r"(?P<in>in\((?P<inlist>[^)]*)\))|"
    r"(?P<op>!=|>=|<=|>|<|~)?(?P<value>.+)"
    r")$",
    re.IGNORECASE,
)

_OP_MAP = {None: "eq", "!=": "ne", ">": "gt", ">=": "gte", "<": "lt",
           "<=": "lte", "~": "contains"}


class FilterParseError(ValueError):
    pass


def _coerce(raw: str) -> Any:
    raw = raw.strip().strip('"').strip("'")
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


class FilterParser:
    """parse(text) -> AST (reference metadata.py:165-268)."""

    def parse(self, text: str) -> Node:
        self._tokens = self._tokenize(text)
        self._pos = 0
        node = self._parse_or()
        if self._pos != len(self._tokens):
            raise FilterParseError(f"unexpected token: {self._tokens[self._pos]}")
        return node

    def _tokenize(self, text: str) -> List[tuple]:
        tokens: List[tuple] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if m is None:
                if text[pos:].strip():
                    raise FilterParseError(f"cannot tokenize: {text[pos:]!r}")
                break
            pos = m.end()
            for kind in ("lparen", "rparen", "and", "or", "not", "cond"):
                if m.group(kind):
                    tokens.append((kind, m.group(kind)))
                    break
        return tokens

    def _peek(self) -> Optional[tuple]:
        return self._tokens[self._pos] if self._pos < len(self._tokens) else None

    def _eat(self, kind: str) -> tuple:
        tok = self._peek()
        if tok is None or tok[0] != kind:
            raise FilterParseError(f"expected {kind}, got {tok}")
        self._pos += 1
        return tok

    def _parse_or(self) -> Node:
        parts = [self._parse_and()]
        while (tok := self._peek()) and tok[0] == "or":
            self._pos += 1
            parts.append(self._parse_and())
        return parts[0] if len(parts) == 1 else Or(parts)

    def _parse_and(self) -> Node:
        parts = [self._parse_not()]
        while (tok := self._peek()) and tok[0] == "and":
            self._pos += 1
            parts.append(self._parse_not())
        return parts[0] if len(parts) == 1 else And(parts)

    def _parse_not(self) -> Node:
        tok = self._peek()
        if tok and tok[0] == "not":
            self._pos += 1
            return Not(self._parse_not())
        return self._parse_atom()

    def _parse_atom(self) -> Node:
        tok = self._peek()
        if tok is None:
            raise FilterParseError("unexpected end of filter")
        if tok[0] == "lparen":
            self._pos += 1
            node = self._parse_or()
            self._eat("rparen")
            return node
        kind, raw = self._eat("cond")
        m = _COND_RE.match(raw)
        if m is None:
            raise FilterParseError(f"bad condition: {raw!r}")
        field = m.group("field")
        if m.group("in"):
            values = [_coerce(v) for v in m.group("inlist").split(",") if v.strip()]
            return Condition(field, "in", values)
        op = _OP_MAP[m.group("op")]
        return Condition(field, op, _coerce(m.group("value")))


# -- evaluation (reference metadata.py:323-367) ---------------------------------------


def _get_field(meta: Dict[str, Any], dotted: str) -> Any:
    cur: Any = meta
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _eval_condition(cond: Condition, meta: Dict[str, Any]) -> bool:
    val = _get_field(meta, cond.field)
    if cond.op == "eq":
        return val == cond.value
    if cond.op == "ne":
        return val != cond.value
    if cond.op == "contains":
        return isinstance(val, str) and str(cond.value).lower() in val.lower()
    if cond.op == "in":
        return val in cond.value
    if val is None:
        return False
    try:
        fv, cv = float(val), float(cond.value)
    except (TypeError, ValueError):
        return False
    return {"gt": fv > cv, "gte": fv >= cv, "lt": fv < cv, "lte": fv <= cv}[cond.op]


def evaluate(node: Node, meta: Dict[str, Any]) -> bool:
    if isinstance(node, Condition):
        return _eval_condition(node, meta)
    if isinstance(node, And):
        return all(evaluate(p, meta) for p in node.parts)
    if isinstance(node, Or):
        return any(evaluate(p, meta) for p in node.parts)
    if isinstance(node, Not):
        return not evaluate(node.part, meta)
    raise TypeError(f"bad node: {node!r}")


# -- SQL compilation (reference metadata.py:319, 369-412) ------------------------------


def to_sql(node: Node, json_column: str = "meta_json") -> tuple:
    """Compile to a SQLite WHERE clause over a JSON column; returns
    (sql, params)."""
    params: List[Any] = []

    def emit(n: Node) -> str:
        if isinstance(n, Condition):
            path = "$." + n.field
            expr = f"json_extract({json_column}, ?)"
            if n.op == "eq":
                params.extend([path, n.value])
                return f"{expr} = ?"
            if n.op == "ne":
                params.extend([path, n.value])
                return f"{expr} != ?"
            if n.op == "contains":
                params.extend([path, f"%{n.value}%"])
                return f"{expr} LIKE ?"
            if n.op == "in":
                params.append(path)
                placeholders = ",".join("?" for _ in n.value)
                params.extend(n.value)
                return f"{expr} IN ({placeholders})"
            sql_op = {"gt": ">", "gte": ">=", "lt": "<", "lte": "<="}[n.op]
            params.extend([path, n.value])
            return f"CAST({expr} AS REAL) {sql_op} ?"
        if isinstance(n, And):
            return "(" + " AND ".join(emit(p) for p in n.parts) + ")"
        if isinstance(n, Or):
            return "(" + " OR ".join(emit(p) for p in n.parts) + ")"
        if isinstance(n, Not):
            return "NOT (" + emit(n.part) + ")"
        raise TypeError(f"bad node: {n!r}")

    return emit(node), params


# -- device pre-filter mask --------------------------------------------------------------


def to_bias(
    node: Node, metadata_by_doc: Dict[int, Dict[str, Any]], n_docs: int
) -> np.ndarray:
    """Compile a filter to a [n_docs] 0/-inf score-bias vector for the dense
    kernel — docs failing the filter never enter top-k selection. A doc
    with no metadata is judged as ``{}``: that verdict is taken once and
    only the docs that carry metadata are evaluated one by one."""
    bias = np.full(n_docs, 0.0 if evaluate(node, {}) else -np.inf, dtype=np.float32)
    for doc_id, meta in metadata_by_doc.items():
        if 0 <= doc_id < n_docs:
            bias[doc_id] = 0.0 if evaluate(node, meta) else -np.inf
    return bias


# -- schema validation (reference metadata.py:25-108) --------------------------------------


@dataclasses.dataclass
class FieldSpec:
    name: str
    type: str  # "str" | "int" | "float" | "bool" | "list"
    required: bool = False

    _CHECKS: Dict[str, Callable[[Any], bool]] = dataclasses.field(
        default_factory=lambda: {}, repr=False
    )


_TYPE_CHECKS: Dict[str, Callable[[Any], bool]] = {
    "str": lambda v: isinstance(v, str),
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "float": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "bool": lambda v: isinstance(v, bool),
    "list": lambda v: isinstance(v, list),
}


class MetadataSchema:
    """Typed schema validation (reference metadata.py:25-108)."""

    def __init__(self, fields: Sequence[FieldSpec]) -> None:
        self.fields = {f.name: f for f in fields}

    def validate(self, metadata: Dict[str, Any]) -> List[str]:
        """Returns a list of violations (empty = valid)."""
        errors: List[str] = []
        for name, spec in self.fields.items():
            if name not in metadata:
                if spec.required:
                    errors.append(f"missing required field: {name}")
                continue
            if spec.type in _TYPE_CHECKS and not _TYPE_CHECKS[spec.type](
                metadata[name]
            ):
                errors.append(
                    f"field {name}: expected {spec.type}, "
                    f"got {type(metadata[name]).__name__}"
                )
        return errors


class MetadataFilterEngine:
    """Facade tying parser + store + device mask together (reference
    MetadataFilter/MetadataStore, metadata.py:111-367)."""

    def __init__(self, store=None, schema: Optional[MetadataSchema] = None) -> None:
        self.store = store
        self.schema = schema
        self.parser = FilterParser()

    def set_metadata(self, doc_id: int, metadata: Dict[str, Any]) -> None:
        if self.schema is not None:
            errors = self.schema.validate(metadata)
            if errors:
                raise ValueError("; ".join(errors))
        if self.store is not None:
            self.store.set_metadata(doc_id, metadata)

    def get_metadata(self, doc_id: int) -> Optional[Dict[str, Any]]:
        return self.store.get_metadata(doc_id) if self.store is not None else None

    def filter_results(self, filter_text: str, results, metadata=None):
        """Post-filter (score, content, doc_id) tuples — the reference's
        semantics (api.py:759-791) for small result sets."""
        node = self.parser.parse(filter_text)
        metadata = metadata if metadata is not None else (
            self.store.all_metadata() if self.store else {}
        )
        return [
            r for r in results if evaluate(node, metadata.get(r[2], {}))
        ]

    def bias_for(self, filter_text: str, n_docs: int) -> np.ndarray:
        """Pre-filter device mask over the whole corpus."""
        node = self.parser.parse(filter_text)
        metadata = self.store.all_metadata() if self.store else {}
        return to_bias(node, metadata, n_docs)
