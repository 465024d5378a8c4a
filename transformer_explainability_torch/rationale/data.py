"""ERASER dataset structures + jsonl IO.

A copy of ``transformer_explainability_tpu/rationale/data.py`` (the port
imports nothing of the JAX package). Behavioral port of reference
``BERT_rationale_benchmark/utils.py:9-202``: frozen dataclasses for
evidence spans and annotations, jsonl round-trip in the exact on-disk
schema, document loading (newline-separated sentences of space-joined
tokens), and word interning for the vestigial non-BERT path.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, is_dataclass
from itertools import chain
from typing import Dict, FrozenSet, List, Set, Tuple, Union


@dataclass(eq=True, frozen=True)
class Evidence:
    """One evidence span. ``start_token`` inclusive, ``end_token`` exclusive;
    sentence bounds are best-effort extras (reference ``utils.py:9-26``)."""
    text: Union[str, Tuple[int, ...], Tuple[str, ...]]
    docid: str
    start_token: int = -1
    end_token: int = -1
    start_sentence: int = -1
    end_sentence: int = -1


@dataclass(eq=True, frozen=True)
class Annotation:
    """One labeled instance with its evidence groups; each group alone
    suffices to justify ``classification`` (reference ``utils.py:29-54``)."""
    annotation_id: str
    query: Union[str, Tuple[int, ...]]
    evidences: Union[Set[Tuple[Evidence, ...]], FrozenSet[Tuple[Evidence, ...]]]
    classification: str
    query_type: str = None
    docids: Set[str] = None

    def all_evidences(self) -> Tuple[Evidence, ...]:
        return tuple(chain.from_iterable(self.evidences))


def _to_jsonable(obj):
    if is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in asdict(obj).items()}
    if isinstance(obj, dict):
        return {_to_jsonable(k): _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (set, frozenset, list, tuple)):
        return tuple(_to_jsonable(x) for x in obj)
    return obj


def annotations_to_jsonl(annotations, output_file: str) -> None:
    with open(output_file, "w") as f:
        for ann in sorted(annotations, key=lambda a: a.annotation_id):
            f.write(json.dumps(_to_jsonable(ann), sort_keys=True))
            f.write("\n")


def annotations_from_jsonl(fp: str) -> List[Annotation]:
    out = []
    with open(fp) as f:
        for line in f:
            d = json.loads(line)
            d["evidences"] = frozenset(
                tuple(Evidence(**ev) for ev in group)
                for group in d["evidences"])
            out.append(Annotation(**d))
    return out


def load_jsonl(fp: str) -> List[dict]:
    with open(fp) as f:
        return [json.loads(line) for line in f]


def write_jsonl(rows, output_file: str) -> None:
    with open(output_file, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True))
            f.write("\n")


def load_datasets(data_dir: str):
    """(train, val, test) annotation lists from ``{split}.jsonl``
    (reference ``utils.py:123-133``)."""
    return tuple(
        annotations_from_jsonl(os.path.join(data_dir, s + ".jsonl"))
        for s in ("train", "val", "test"))


def load_documents(data_dir: str, docids: Set[str] = None) -> Dict[str, str]:
    """docid -> raw text. Documents live either as individual files under
    ``docs/`` or as one ``docs.jsonl`` (reference ``utils.py:136-154``)."""
    docs_jsonl = os.path.join(data_dir, "docs.jsonl")
    if os.path.exists(docs_jsonl):
        assert not os.path.exists(os.path.join(data_dir, "docs"))
        rows = load_jsonl(docs_jsonl)
        wanted = None if docids is None else set(str(d) for d in docids)
        return {r["docid"]: r["document"] for r in rows
                if wanted is None or r["docid"] in wanted}
    docs_dir = os.path.join(data_dir, "docs")
    if docids is None:
        docids = sorted(os.listdir(docs_dir))
    else:
        docids = sorted(set(str(d) for d in docids))
    out = {}
    for d in docids:
        with open(os.path.join(docs_dir, d)) as f:
            out[d] = f.read()
    return out


def split_into_sentences(raw: str) -> List[List[str]]:
    """newline-separated sentences of space-joined tokens (the ERASER
    on-disk document format)."""
    return [s.split() for s in raw.splitlines() if s.strip()]


def load_sentence_documents(data_dir: str, docids: Set[str] = None
                            ) -> Dict[str, List[List[str]]]:
    return {d: split_into_sentences(raw)
            for d, raw in load_documents(data_dir, docids).items()}


def load_flattened_documents(data_dir: str, docids: Set[str] = None
                             ) -> Dict[str, List[str]]:
    """docid -> flat token list (reference ``utils.py:157-166``)."""
    return {d: list(chain.from_iterable(sents))
            for d, sents in load_sentence_documents(data_dir, docids).items()}


def intern_documents(documents: Dict[str, List[List[str]]],
                     word_interner: Dict[str, int], unk_token: str):
    unk = word_interner[unk_token]
    return {d: [[word_interner.get(w, unk) for w in s] for s in sents]
            for d, sents in documents.items()}


def intern_annotations(annotations: List[Annotation],
                       word_interner: Dict[str, int], unk_token: str):
    unk = word_interner[unk_token]

    def intern_text(text: str) -> Tuple[int, ...]:
        return tuple(word_interner.get(t, unk) for t in text.split())

    out = []
    for ann in annotations:
        groups = frozenset(
            tuple(Evidence(text=intern_text(ev.text), docid=ev.docid,
                           start_token=ev.start_token, end_token=ev.end_token,
                           start_sentence=ev.start_sentence,
                           end_sentence=ev.end_sentence)
                  for ev in group)
            for group in ann.evidences)
        out.append(Annotation(annotation_id=ann.annotation_id,
                              query=intern_text(ann.query), evidences=groups,
                              classification=ann.classification,
                              query_type=ann.query_type))
    return out
