"""ERASER rationale + classification scorer.

Behavioral port of reference ``BERT_rationale_benchmark/metrics.py`` (674
LoC): IOU partial-match F1 (:111-166), instance micro/macro token F1
(:168-215), soft-token AUPRC/AP/ROC-AUC (:217-253), comprehensiveness /
sufficiency + AOPC (:255-364), the strict instance validator (:366-523) and
the CLI (:545-674). Pure numpy/scipy/sklearn — no torch.

A copy of ``transformer_explainability_tpu/rationale/metrics.py`` with
scikit-learn imported by the functions that need it (``_auprc``,
``score_soft_tokens``, ``score_classifications``): the hard-rationale
scores (``partial_match_score``, ``score_hard_rationale_predictions`` and
``score_results`` on hard predictions) run where scikit-learn is absent.

One deliberate divergence: the reference's ``load_flattened_documents``
flattens *raw document strings* into characters (its tokenizing code is
commented out, ``utils.py:214-223``); we flatten whitespace tokens, which is
what the span indices produced by the pipeline actually index.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pprint
from collections import Counter, defaultdict
from dataclasses import dataclass
from itertools import chain
from typing import Any, Callable, Dict, List, Set, Tuple

import numpy as np
from scipy.stats import entropy

from transformer_explainability_torch.rationale.data import (
    Annotation, annotations_from_jsonl, load_flattened_documents, load_jsonl,
    load_sentence_documents)

logger = logging.getLogger(__name__)


@dataclass(eq=True, frozen=True)
class Rationale:
    """A predicted or gold span; start inclusive, end exclusive
    (reference ``metrics.py:29-57``)."""
    ann_id: str
    docid: str
    start_token: int
    end_token: int

    def to_token_level(self) -> List["Rationale"]:
        return [Rationale(self.ann_id, self.docid, t, t + 1)
                for t in range(self.start_token, self.end_token)]

    @classmethod
    def from_annotation(cls, ann: Annotation) -> List["Rationale"]:
        return [cls(ann.annotation_id, ev.docid, ev.start_token, ev.end_token)
                for group in ann.evidences for ev in group]

    @classmethod
    def from_instance(cls, inst: dict) -> List["Rationale"]:
        return [cls(inst["annotation_id"], rat["docid"],
                    pred["start_token"], pred["end_token"])
                for rat in inst["rationales"]
                for pred in rat.get("hard_rationale_predictions", [])]


@dataclass(eq=True, frozen=True)
class PositionScoredDocument:
    """Per-position (score, truth) pairing for soft metrics
    (reference ``metrics.py:59-99``)."""
    ann_id: str
    docid: str
    scores: Tuple[float, ...]
    truths: Tuple[bool, ...]

    @classmethod
    def from_results(cls, instances: List[dict],
                     annotations: List[Annotation],
                     docs: Dict[str, List[Any]], use_tokens: bool = True
                     ) -> List["PositionScoredDocument"]:
        key_to_truth: Dict[Tuple[str, str], List[bool]] = {}
        for ann in annotations:
            for ev in chain.from_iterable(ann.evidences):
                key = (ann.annotation_id, ev.docid)
                if key not in key_to_truth:
                    key_to_truth[key] = [False] * len(docs[ev.docid])
                start, end = ((ev.start_token, ev.end_token) if use_tokens
                              else (ev.start_sentence, ev.end_sentence))
                for t in range(start, end):
                    key_to_truth[key][t] = True
        field = ("soft_rationale_predictions" if use_tokens
                 else "soft_sentence_predictions")
        out = []
        for inst in instances:
            for rat in inst["rationales"]:
                docid = rat["docid"]
                scores = rat[field]
                key = (inst["annotation_id"], docid)
                assert len(scores) == len(docs[docid])
                if key not in key_to_truth:
                    # prediction on a doc with no gold evidence
                    key_to_truth[key] = [False] * len(docs[docid])
                out.append(cls(inst["annotation_id"], docid, tuple(scores),
                               tuple(key_to_truth[key])))
        return out


def _f1(p: float, r: float) -> float:
    return 0 if p == 0 or r == 0 else 2 * p * r / (p + r)


def _by_key(rats) -> Dict[Tuple[str, str], Set[Rationale]]:
    out = defaultdict(set)
    for r in rats:
        out[(r.ann_id, r.docid)].add(r)
    return out


def _span_iou(a: Rationale, b: Rationale) -> float:
    inter = max(0, min(a.end_token, b.end_token)
                - max(a.start_token, b.start_token))
    union = len(set(range(a.start_token, a.end_token))
                | set(range(b.start_token, b.end_token)))
    return 0 if union == 0 else inter / union


def partial_match_score(truth: List[Rationale], pred: List[Rationale],
                        thresholds: List[float]) -> List[Dict[str, Any]]:
    """IOU-thresholded partial-match micro/macro F1
    (reference ``metrics.py:111-166``)."""
    ann_to_rat = _by_key(truth)
    pred_to_rat = _by_key(pred)
    n_pred = {k: len(v) for k, v in pred_to_rat.items()}
    n_truth = {k: len(v) for k, v in ann_to_rat.items()}
    ious: Dict[Tuple[str, str], Dict[Rationale, float]] = defaultdict(dict)
    for k in set(ann_to_rat) | set(pred_to_rat):
        for p in pred_to_rat.get(k, []):
            ious[k][p] = max(
                (_span_iou(p, t) for t in ann_to_rat.get(k, [])), default=0.0)
    scores = []
    for threshold in thresholds:
        tps = {k: sum(int(x >= threshold) for x in vs.values())
               for k, vs in ious.items()}
        total_tp = sum(tps.values())
        micro_r = total_tp / sum(n_truth.values()) if n_truth else 0
        micro_p = total_tp / sum(n_pred.values()) if sum(n_pred.values()) else 0
        macro_rs = [tps.get(k, 0.0) / n if n > 0 else 0
                    for k, n in n_truth.items()]
        macro_ps = [tps.get(k, 0.0) / n if n > 0 else 0
                    for k, n in n_pred.items()]
        macro_r = float(np.mean(macro_rs)) if macro_rs else 0
        macro_p = float(np.mean(macro_ps)) if macro_ps else 0
        scores.append({
            "threshold": threshold,
            "micro": {"p": micro_p, "r": micro_r, "f1": _f1(micro_p, micro_r)},
            "macro": {"p": macro_p, "r": macro_r, "f1": _f1(macro_p, macro_r)},
        })
    return scores


def score_hard_rationale_predictions(truth: List[Rationale],
                                     pred: List[Rationale]
                                     ) -> Dict[str, Dict[str, float]]:
    """Exact-span instance micro/macro P/R/F1
    (reference ``metrics.py:168-216``)."""
    truth_s, pred_s = set(truth), set(pred)
    micro_p = len(truth_s & pred_s) / len(pred_s)
    micro_r = len(truth_s & pred_s) / len(truth_s)
    scores = {"instance_micro": {
        "p": micro_p, "r": micro_r, "f1": _f1(micro_p, micro_r)}}

    ann_to_rat = _by_key(truth_s)
    pred_to_rat = _by_key(pred_s)
    per_instance = []
    for k in set(ann_to_rat) | set(pred_to_rat):
        hit = len(ann_to_rat.get(k, set()) & pred_to_rat.get(k, set()))
        p = hit / len(pred_to_rat[k]) if pred_to_rat.get(k) else 0
        r = hit / len(ann_to_rat[k]) if ann_to_rat.get(k) else 0
        per_instance.append({"p": p, "r": r, "f1": _f1(p, r)})
    scores["instance_macro"] = {
        key: float(np.mean([i[key] for i in per_instance]))
        for key in ("p", "r", "f1")}
    return scores


def _auprc(truth: Dict[Any, List[bool]], preds: Dict[Any, List[float]]
           ) -> float:
    if not preds:
        return 0.0
    from sklearn.metrics import auc, precision_recall_curve
    aucs = []
    for k, true in truth.items():
        precision, recall, _ = precision_recall_curve(
            [int(t) for t in true], preds[k])
        aucs.append(auc(recall, precision))
    return float(np.average(aucs))


def _score_aggregator(truth: Dict[Any, List[bool]],
                      preds: Dict[Any, List[float]],
                      score_function: Callable,
                      discard_single_class_answers: bool) -> float:
    if not preds:
        return 0.0
    scores = []
    for k, true in truth.items():
        if discard_single_class_answers and (
                all(true) or not any(true)):
            continue
        scores.append(score_function([int(t) for t in true], preds[k]))
    return float(np.average(scores))


def score_soft_tokens(paired: List[PositionScoredDocument]
                      ) -> Dict[str, float]:
    """AUPRC / AP / ROC-AUC over per-token soft scores
    (reference ``metrics.py:243-254``)."""
    from sklearn.metrics import average_precision_score, roc_auc_score
    truth = {(p.ann_id, p.docid): p.truths for p in paired}
    pred = {(p.ann_id, p.docid): p.scores for p in paired}
    return {
        "auprc": _auprc(truth, pred),
        "average_precision": _score_aggregator(
            truth, pred, average_precision_score, True),
        "roc_auc_score": _score_aggregator(truth, pred, roc_auc_score, True),
    }


def _instances_aopc(instances: List[dict], thresholds: List[float],
                    key: str) -> Tuple[float, List[float]]:
    dataset_scores = []
    for inst in instances:
        kls = inst["classification"]
        beta_0 = inst["classification_scores"][kls]
        row = [beta_0 - s[key][kls]
               for s in sorted(inst["thresholded_scores"],
                               key=lambda x: x["threshold"])
               if s["threshold"] in thresholds]
        assert len(row) == len(thresholds)
        dataset_scores.append(row)
    arr = np.array(dataset_scores)
    return float(np.average(arr)), np.average(arr, axis=0).tolist()


def compute_aopc_scores(instances: List[dict], aopc_thresholds):
    if aopc_thresholds is None:
        aopc_thresholds = sorted(set(chain.from_iterable(
            [x["threshold"] for x in y["thresholded_scores"]]
            for y in instances)))
    comp, comp_pts = _instances_aopc(
        instances, aopc_thresholds, "comprehensiveness_classification_scores")
    suff, suff_pts = _instances_aopc(
        instances, aopc_thresholds, "sufficiency_classification_scores")
    return aopc_thresholds, comp, comp_pts, suff, suff_pts


def score_classifications(instances: List[dict],
                          annotations: List[Annotation],
                          docs: Dict[str, List[str]],
                          aopc_thresholds) -> Dict[str, Any]:
    """Accuracy/PRF + faithfulness (comprehensiveness, sufficiency, their
    entropies/KLs, AOPC curves) — reference ``metrics.py:286-364``."""
    from sklearn.metrics import accuracy_score, classification_report

    def kl(base, faith):
        keys = list(base.keys())
        return entropy([faith[k] for k in keys], [base[k] for k in keys])

    labels = list(set(a.classification for a in annotations))
    label_to_int = {l: i for i, l in enumerate(labels)}
    by_id = {inst["annotation_id"]: inst for inst in instances}
    truth = [label_to_int[a.classification] for a in annotations]
    predicted = [label_to_int[by_id[a.annotation_id]["classification"]]
                 for a in annotations]
    out: Dict[str, Any] = {
        "accuracy": accuracy_score(truth, predicted),
        "prf": classification_report(truth, predicted, output_dict=True,
                                     target_names=labels, digits=3),
    }

    for name, field in (
            ("comprehensiveness", "comprehensiveness_classification_scores"),
            ("sufficiency", "sufficiency_classification_scores")):
        if field in instances[0]:
            deltas = [x["classification_scores"][x["classification"]]
                      - x[field][x["classification"]] for x in instances]
            out[name] = float(np.average(deltas))
            ent = [entropy(list(x["classification_scores"].values()))
                   - entropy(list(x[field].values())) for x in instances]
            out[f"{name}_entropy"] = float(np.average(ent))
            out[f"{name}_kl"] = float(np.average(
                [kl(x["classification_scores"], x[field]) for x in instances]))
        else:
            out[name] = out[f"{name}_entropy"] = out[f"{name}_kl"] = None

    if "thresholded_scores" in instances[0]:
        (ts, comp, comp_pts, suff, suff_pts) = compute_aopc_scores(
            instances, aopc_thresholds)
    else:
        ts = comp = comp_pts = suff = suff_pts = None
    out.update({
        "aopc_thresholds": ts,
        "comprehensiveness_aopc": comp,
        "comprehensiveness_aopc_points": comp_pts,
        "sufficiency_aopc": suff,
        "sufficiency_aopc_points": suff_pts,
    })

    if "tokens_to_flip" in instances[0]:
        pcts = []
        for ann in annotations:
            docids = set(ev.docid
                         for ev in chain.from_iterable(ann.evidences))
            doc_len = sum(len(docs[d]) for d in docids)
            pcts.append(by_id[ann.annotation_id]["tokens_to_flip"] / doc_len)
        out["token_percentages"] = float(np.average(pcts))
    return out


# ---------------------------------------------------------------------------
# Validation (reference metrics.py:366-523)
# ---------------------------------------------------------------------------

def verify_instance(instance: dict, docs: Dict[str, list],
                    thresholds) -> bool:
    """Returns True when the instance is malformed; logs each defect."""
    error = False
    aid = instance.get("annotation_id")
    for rat in instance["rationales"]:
        docid = rat["docid"]
        if docid not in docs:
            error = True
            logger.info("instance %s: docid %s has no document", aid, docid)
            continue
        doc_length = len(docs[docid])
        hards = rat.get("hard_rationale_predictions", [])
        for i, h1 in enumerate(hards):
            for h2 in hards[i + 1:]:
                if (h1 != h2 and
                        min(h1["end_token"], h2["end_token"]) >
                        max(h1["start_token"], h2["start_token"])):
                    error = True
                    logger.info("instance %s doc %s: spans %s and %s overlap",
                                aid, docid, h1, h2)
            if h1["start_token"] > doc_length or h1["end_token"] > doc_length:
                error = True
                logger.info("instance %s doc %s: span %s exceeds doc length %d",
                            aid, docid, h1, doc_length)
        soft = rat.get("soft_rationale_predictions", [])
        if soft and len(soft) != doc_length:
            error = True
            logger.info("instance %s doc %s: %d soft scores for %d tokens",
                        aid, docid, len(soft), doc_length)

    for field, typ in (("classification", str),
                       ("classification_scores", dict),
                       ("comprehensiveness_classification_scores", dict),
                       ("sufficiency_classification_scores", dict)):
        if field in instance and not isinstance(instance[field], typ):
            error = True
            logger.info("instance %s: %s is not a %s", aid, field,
                        typ.__name__)
    if ("classification" in instance) != ("classification_scores" in instance):
        error = True
        logger.info("instance %s: classification and classification_scores "
                    "must come together", aid)
    if ("comprehensiveness_classification_scores" in instance
            and "classification" not in instance):
        error = True
        logger.info("instance %s: comprehensiveness requires classification",
                    aid)
    if ("sufficiency_classification_scores" in instance
            and "classification_scores" not in instance):
        error = True
        logger.info("instance %s: sufficiency requires classification_scores",
                    aid)
    if "thresholded_scores" in instance:
        inst_thresholds = set(x["threshold"]
                              for x in instance["thresholded_scores"])
        if inst_thresholds != thresholds:
            error = True
            logger.info("instance %s: inconsistent thresholds", aid)
        required = ("comprehensiveness_classification_scores",
                    "sufficiency_classification_scores",
                    "classification", "classification_scores")
        if not all(r in instance for r in required):
            error = True
            logger.info("instance %s: thresholded_scores requires %s",
                        aid, required)
        for r in ("sufficiency_classification_scores",
                  "comprehensiveness_classification_scores"):
            if not all(r in x for x in instance["thresholded_scores"]):
                error = True
                logger.info("instance %s: every threshold needs %s", aid, r)
    return error


def verify_instances(instances: List[dict], docs: Dict[str, list]) -> None:
    """All-or-nothing field consistency across the result file; raises
    ValueError on any defect (reference ``metrics.py:455-523``)."""
    counts = Counter(x["annotation_id"] for x in instances)
    error = False
    dups = [k for k, v in counts.items() if v > 1]
    if dups:
        error = True
        logger.info("%d annotation ids appear multiple times: %s",
                    len(dups), dups)
    thresholds = (set(x["threshold"]
                      for x in instances[0]["thresholded_scores"])
                  if "thresholded_scores" in instances[0] else None)
    populations = defaultdict(list)
    for inst in instances:
        if verify_instance(inst, docs, thresholds):
            error = True
        for field in ("classification",
                      "comprehensiveness_classification_scores",
                      "sufficiency_classification_scores",
                      "thresholded_scores"):
            if inst.get(field) is not None:
                populations[field].append(inst)
        soft_tok = [r for r in inst["rationales"]
                    if r.get("soft_rationale_predictions") is not None]
        soft_sent = [r for r in inst["rationales"]
                     if r.get("soft_sentence_predictions") is not None]
        if soft_tok:
            populations["soft_rationale"].append(inst)
            if len(soft_tok) != len(inst["rationales"]):
                error = True
                logger.info("instance %s: soft rationales for only some docs",
                            inst["annotation_id"])
        if soft_sent:
            populations["soft_sentence"].append(inst)
            if len(soft_sent) != len(inst["rationales"]):
                error = True
                logger.info("instance %s: soft sentences for only some docs",
                            inst["annotation_id"])
    for field, pop in populations.items():
        if len(pop) not in (0, len(instances)):
            error = True
            logger.info("field %s present on %d/%d instances — must be all "
                        "or none", field, len(pop), len(instances))
    if error:
        raise ValueError(
            "Some instances are invalid, please fix your formatting "
            "and try again")


def _has_hard_predictions(results: List[dict]) -> bool:
    r = results[0].get("rationales")
    return bool(r) and bool(r[0].get("hard_rationale_predictions"))


def _has_soft_predictions(results: List[dict]) -> bool:
    r = results[0].get("rationales")
    return bool(r) and r[0].get("soft_rationale_predictions") is not None


def _has_soft_sentence_predictions(results: List[dict]) -> bool:
    r = results[0].get("rationales")
    return bool(r) and r[0].get("soft_sentence_predictions") is not None


def _has_classifications(results: List[dict]) -> bool:
    return results[0].get("classification") is not None


def score_results(results: List[dict], annotations: List[Annotation],
                  data_dir: str, iou_thresholds=(0.5,),
                  aopc_thresholds=(0.01, 0.05, 0.1, 0.2, 0.5)
                  ) -> Dict[str, Any]:
    """Library entry point: everything the reference CLI computes
    (``metrics.py:613-668``), returned as one dict."""
    docids = set(chain.from_iterable(
        [rat["docid"] for rat in res["rationales"]] for res in results))
    docids |= set(chain.from_iterable(
        (ev.docid for ev in chain.from_iterable(ann.evidences))
        for ann in annotations))
    flattened = load_flattened_documents(data_dir, docids)
    verify_instances(results, flattened)

    scores: Dict[str, Any] = {}
    if _has_hard_predictions(results):
        truth = list(chain.from_iterable(
            Rationale.from_annotation(ann) for ann in annotations))
        pred = list(chain.from_iterable(
            Rationale.from_instance(inst) for inst in results))
        if iou_thresholds is not None:
            scores["iou_scores"] = partial_match_score(
                truth, pred, list(iou_thresholds))
        scores["rationale_prf"] = score_hard_rationale_predictions(
            truth, pred)
        scores["token_prf"] = score_hard_rationale_predictions(
            list(chain.from_iterable(r.to_token_level() for r in truth)),
            list(chain.from_iterable(r.to_token_level() for r in pred)))
    if _has_soft_predictions(results):
        paired = PositionScoredDocument.from_results(
            results, annotations, flattened, use_tokens=True)
        scores["token_soft_metrics"] = score_soft_tokens(paired)
    if _has_soft_sentence_predictions(results):
        sent_docs = load_sentence_documents(data_dir, docids)
        paired = PositionScoredDocument.from_results(
            results, annotations, sent_docs, use_tokens=False)
        scores["sentence_soft_metrics"] = score_soft_tokens(paired)
    if _has_classifications(results):
        scores["classification_scores"] = score_classifications(
            results, annotations, flattened,
            list(aopc_thresholds) if aopc_thresholds else None)
    return scores


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Computes rationale and final class classification "
                    "scores against ERASER gold annotations")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--split", required=True,
                        help="train|val|test")
    parser.add_argument("--results", required=True,
                        help="results jsonl (see reference metrics.py:549 "
                             "for the schema)")
    parser.add_argument("--strict", action="store_true", default=False)
    parser.add_argument("--iou_thresholds", nargs="+", type=float,
                        default=[0.5])
    parser.add_argument("--aopc_thresholds", nargs="+", type=float,
                        default=[0.01, 0.05, 0.1, 0.2, 0.5])
    parser.add_argument("--score_file", default=None)
    args = parser.parse_args(argv)

    results = load_jsonl(args.results)
    annotations = annotations_from_jsonl(
        os.path.join(args.data_dir, args.split + ".jsonl"))
    if args.strict:
        if not args.iou_thresholds:
            raise ValueError("--iou_thresholds required for strict scoring")
        if not _has_classifications(results):
            raise ValueError("strict scoring requires classification fields")
    scores = score_results(results, annotations, args.data_dir,
                           args.iou_thresholds, args.aopc_thresholds)
    pprint.pprint(scores)
    if args.score_file:
        with open(args.score_file, "w") as f:
            json.dump(scores, f, indent=4, sort_keys=True)
    return scores


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
