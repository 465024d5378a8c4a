"""End-to-end ERASER pipeline on the card: fine-tune a BERT classifier,
explain the test split, decode hard rationales, render LaTeX heatmaps.

Port of ``transformer_explainability_tpu/rationale/pipeline.py`` (the
reference's ``BERT_rationale_benchmark/models/pipeline/bert_pipeline.py``).
Same stages and files:

  * tokenize + cache (``preprocessed.pkl``), every encoding padded to
    ``max_length``;
  * fine-tune: sum-reduced cross-entropy times 0/1 row weights, optax's
    global-norm clip, Adam (``torch.optim.Adam``, optax ``adam``'s
    defaults), dropout at the Hugging Face sites
    (:func:`..models.bert.train_forward`, masks from a seeded generator on
    the card), val-accuracy early stopping with patience, the best epoch's
    weights in ``classifier/classifier.npz`` and the epoch record in
    ``classifier/epoch_data.json`` (a rerun resumes from them), shuffles by
    ``random.Random(seed)`` as JAX makes them. Exact FP32 (TF32 off);
  * explain: the method table through the port's
    :class:`..explain.bert_generator.BertExplainer` on the card at the
    precision JAX passes for each ``matmul_precision`` (``float32``: the
    plain layers and the rollout kernel; ``bfloat16``: the layer kernels
    and the rollout kernel); ground-truth and counterfactual LaTeX
    heatmaps; wordpiece → word max-pooling; top-k (k = 5..80 step 5) hard
    rationales into ``identifier_results_{k}.json``.

JAX pads each batch to a power-of-two bucket so that its jitted programs
compile once; the port runs any batch size, so its loops pass the batch as
it is with unit row weights (:func:`_padded_batch` is kept for callers that
want JAX's shapes: a padded row weighs 0 and leaves the update as it was).
Entry points default to ``device="cuda"`` and raise where there is no card.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import random
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from transformer_explainability_torch.explain import bert_generator as bg
from transformer_explainability_torch.explain.bert_generator import (
    BertExplainer)
from transformer_explainability_torch.explain.generator import (
    _check_fp32_matmul, _resolve_device)
from transformer_explainability_torch.models import bert as bert_mod
from transformer_explainability_torch.models.bert import (
    BertConfig, BertForSequenceClassification)
from transformer_explainability_torch.rationale import render
from transformer_explainability_torch.rationale.data import (
    Annotation, load_datasets, load_documents)
from transformer_explainability_torch.train import clip_by_global_norm
from transformer_explainability_torch.utils.batching import bucket_size
from transformer_explainability_torch.utils.checkpoint import (
    load_pytree, save_pytree)

Tensor = torch.Tensor
logger = logging.getLogger(__name__)

# explanation method -> (explainer call name, rule variant, start_layer)
# (JAX METHOD_TABLE: "ours" runs on the ours-rules model, every baseline on
#  the orig-LRP model; rollout from layer 0, as the reference's
#  generate_rollout; None = the explainer's method default)
METHOD_TABLE = {
    "transformer_attribution": ("transformer_attribution", "ours", None),
    "partial_lrp": ("last_layer", "lrp", None),
    "last_attn": ("last_layer_attn", "lrp", None),
    "attn_gradcam": ("attn_gradcam", "lrp", None),
    "lrp": ("full", "lrp", None),
    "rollout": ("rollout", "lrp", 0),
}
METHOD_FOLDER = {
    "transformer_attribution": "ours", "partial_lrp": "partial_lrp",
    "last_attn": "last_attn", "attn_gradcam": "attn_gradcam", "lrp": "lrp",
    "rollout": "rollout", "ground_truth": "ground_truth",
}


def docid_of(ann: Annotation) -> str:
    return next(iter(ann.evidences))[0].docid


def evidence_group_of(ann: Annotation):
    return next(iter(ann.evidences))


def explain_precision(matmul_precision: str) -> Dict[str, Optional[str]]:
    """The precision arguments JAX's ``explain_test_split`` gives its
    ``BertExplainer`` at each ``matmul_precision``: at ``tensorfloat32``
    the attention island at float32 and the MLP products at bfloat16, the
    rules at the base."""
    tf32 = matmul_precision == "tensorfloat32"
    return dict(matmul_precision=matmul_precision,
                attn_precision="float32" if tf32 else None,
                mlp_precision="bfloat16" if tf32 else None)


def check_explain_supported(cfg: BertConfig, method: str,
                            matmul_precision: str) -> None:
    """Raise, before any work, for an explain stage the port does not run:
    an unknown method, or a method and precision that have no path on the
    card (``transformer_attribution``'s rules at ``tensorfloat32``, which
    JAX runs at bf16×3 in its layer kernels, have no kernel mode: ROADMAP
    B, raw tensorfloat32). The CPU takes the same paths, so it raises
    alike."""
    if method not in METHOD_TABLE:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(METHOD_TABLE)}")
    call_name, variant, _ = METHOD_TABLE[method]
    bg.check_supported(cfg, call_name, variant=variant,
                       **explain_precision(matmul_precision))


# ---------------------------------------------------------------------------
# Tokenization + cache
# ---------------------------------------------------------------------------

def intern_documents_bert(documents: Dict[str, str], tokenizer,
                          max_length: int, cache_path: Optional[str] = None
                          ) -> Dict[str, Dict[str, np.ndarray]]:
    """docid -> {"input_ids": (max_length,), "attention_mask": (max_length,)}
    (JAX ``intern_documents_bert``; the reference's ``preprocessed.pkl``),
    each padded to ``max_length``."""
    if cache_path and os.path.exists(cache_path):
        logger.info("loading interned documents from %s", cache_path)
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    interned = {}
    for d, doc in documents.items():
        enc = tokenizer(doc, add_special_tokens=True, max_length=max_length,
                        truncation=True, padding="max_length",
                        return_token_type_ids=False,
                        return_attention_mask=True)
        interned[d] = {
            "input_ids": np.asarray(enc["input_ids"], np.int32),
            "attention_mask": np.asarray(enc["attention_mask"], np.int32),
        }
    if cache_path:
        with open(cache_path, "wb") as f:
            pickle.dump(interned, f)
    return interned


def _batch_arrays(anns: List[Annotation], interned, classes: Dict[str, int]):
    ids = np.stack([interned[docid_of(a)]["input_ids"] for a in anns])
    mask = np.stack([interned[docid_of(a)]["attention_mask"] for a in anns])
    targets = np.asarray([classes[a.classification] for a in anns], np.int32)
    return ids, mask, targets


def _padded_batch(anns: List[Annotation], interned, classes: Dict[str, int]):
    """JAX's batch: the arrays with their last row repeated up to a
    power-of-two bucket, the 0/1 row weights and the real row count."""
    ids, mask, targets = _batch_arrays(anns, interned, classes)
    B = len(anns)
    Bp = bucket_size(B)
    weights = np.zeros(Bp, np.float32)
    weights[:B] = 1.0
    if Bp != B:
        pad = Bp - B
        ids = np.concatenate([ids, np.repeat(ids[-1:], pad, axis=0)])
        mask = np.concatenate([mask, np.repeat(mask[-1:], pad, axis=0)])
        targets = np.concatenate([targets, np.repeat(targets[-1:], pad)])
    return ids, mask, targets, weights, B


def _on(device, ids, mask):
    return (torch.as_tensor(np.asarray(ids), device=device).to(torch.int64),
            torch.as_tensor(np.asarray(mask), device=device))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def make_train_step(cfg: BertConfig, max_grad_norm: Optional[float],
                    dropout: float = 0.1):
    """``step(model, opt, ids, mask, targets, weights, generator) -> (loss,
    correct)`` (JAX ``make_train_step``): the per-example cross-entropy of
    :func:`..models.bert.train_forward` (dropout ``dropout`` at every site,
    masks from ``generator``) times ``weights``, summed (the reference's
    ``CrossEntropyLoss(reduction='none').sum()``); its gradients; optax's
    global-norm clip when ``max_grad_norm``; then ``opt.step()``. ``loss``
    and ``correct`` (the weighted count of argmax hits) are 0-d tensors on
    the device, taken before the update."""

    def step(model: BertForSequenceClassification, opt, ids, mask, targets,
             weights, generator: Optional[torch.Generator]):
        if model.cfg != cfg:
            raise ValueError("model config differs from the train step's")
        dtype = model.classifier.weight.dtype
        device = model.classifier.weight.device
        _check_fp32_matmul(device, dtype)
        ids, mask = _on(device, ids, mask)
        targets = torch.as_tensor(np.asarray(targets),
                                  device=device).to(torch.int64)
        weights = torch.as_tensor(np.asarray(weights), device=device,
                                  dtype=dtype)
        opt.zero_grad(set_to_none=True)
        logits = bert_mod.train_forward(model, ids, mask, generator,
                                        hidden_dropout=dropout,
                                        attn_dropout=dropout)
        losses = torch.nn.functional.cross_entropy(logits, targets,
                                                   reduction="none")
        loss = (losses * weights).sum()
        loss.backward()
        if max_grad_norm:
            clip_by_global_norm(model.parameters(), max_grad_norm)
        opt.step()
        with torch.no_grad():
            correct = ((logits.argmax(-1) == targets) * weights).sum()
        return loss.detach(), correct

    return step


def make_eval_step(cfg: BertConfig):
    """``step(model, ids, mask) -> logits``: the plain forward, no dropout
    (JAX ``make_eval_step``)."""

    def step(model: BertForSequenceClassification, ids, mask) -> Tensor:
        if model.cfg != cfg:
            raise ValueError("model config differs from the eval step's")
        device = model.classifier.weight.device
        return model(*_on(device, ids, mask))

    return step


def train_classifier(params: Mapping[str, Tensor], cfg: BertConfig,
                     train: List[Annotation], val: List[Annotation],
                     interned, classes: Dict[str, int], output_dir: str,
                     batch_size: int = 16, epochs: int = 10,
                     patience: int = 3, lr: float = 2e-5,
                     max_grad_norm: Optional[float] = 1.0,
                     dropout: float = 0.1, seed: int = 12345,
                     device="cuda"):
    """Fine-tune with val-accuracy early stopping and epoch checkpoint /
    resume (JAX ``train_classifier``, the reference's :289-418), from
    ``params`` (an HF-named state dict) on ``device`` in the params' dtype.
    Returns ``(best weights as a flat state dict on the device, results
    dict)``. A rerun on the same ``output_dir`` resumes from the saved
    best epoch with a fresh optimizer, as JAX does."""
    device = _resolve_device(device)
    os.makedirs(os.path.join(output_dir, "classifier"), exist_ok=True)
    model_file = os.path.join(output_dir, "classifier", "classifier.npz")
    epoch_file = os.path.join(output_dir, "classifier", "epoch_data.json")

    model = BertForSequenceClassification(
        cfg, device=device, dtype=params["classifier.weight"].dtype)
    model.load_state_dict(params)
    step = make_train_step(cfg, max_grad_norm, dropout)
    eval_step = make_eval_step(cfg)
    generator = torch.Generator(device=device).manual_seed(seed)
    pyrandom = random.Random(seed)

    results = {"train_loss": [], "train_acc": [], "val_loss": [],
               "val_acc": []}
    best_epoch, best_val_acc, best_val_loss = -1, 0.0, float("inf")
    start_epoch = 0
    if os.path.exists(epoch_file):
        with open(epoch_file) as f:
            epoch_data = json.load(f)
        model.load_state_dict(load_pytree(model_file, model.state_dict()))
        start_epoch = epoch_data["epoch"] + 1
        if epoch_data.get("done"):
            start_epoch = epochs
        results = epoch_data["results"]
        best_val_acc = epoch_data["best_val_acc"]
        # the saved checkpoint is the best one: keep its epoch and loss so
        # a resumed run neither overwrites it with an equal-accuracy,
        # higher-loss epoch nor shifts the patience window
        best_epoch = epoch_data.get("best_epoch", epoch_data["epoch"])
        best_val_loss = epoch_data.get("best_val_loss", float("inf"))
        logger.info("restored training at epoch %d (best epoch %d)",
                    start_epoch, best_epoch)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    def run_val():
        total_loss, total_correct = 0.0, 0
        for s in range(0, len(val), 32):
            ids, mask, tgt = _batch_arrays(val[s:s + 32], interned, classes)
            logits = eval_step(model, ids, mask).cpu().numpy()
            total_correct += int((logits.argmax(-1) == tgt).sum())
            shifted = logits - logits.max(-1, keepdims=True)
            logp = shifted - np.log(np.exp(shifted).sum(-1, keepdims=True))
            total_loss += float(-logp[np.arange(len(tgt)), tgt].sum())
        return total_loss / len(val), total_correct / len(val)

    for epoch in range(start_epoch, epochs):
        order = pyrandom.sample(range(len(train)), k=len(train))
        epoch_loss, epoch_correct = 0.0, 0
        for s in range(0, len(order), batch_size):
            anns = [train[i] for i in order[s:s + batch_size]]
            ids, mask, tgt = _batch_arrays(anns, interned, classes)
            loss, correct = step(model, opt, ids, mask, tgt,
                                 np.ones(len(anns), np.float32), generator)
            epoch_loss += float(loss)
            epoch_correct += int(correct)
        epoch_loss /= len(train)
        results["train_loss"].append(epoch_loss)
        results["train_acc"].append(epoch_correct / len(train))
        val_loss, val_acc = run_val()
        results["val_loss"].append(val_loss)
        results["val_acc"].append(val_acc)
        logger.info("epoch %d: train loss %.4f acc %.4f | val loss %.4f "
                    "acc %.4f", epoch, epoch_loss,
                    epoch_correct / len(train), val_loss, val_acc)
        if val_acc > best_val_acc or (val_acc == best_val_acc
                                      and val_loss < best_val_loss):
            best_epoch, best_val_acc, best_val_loss = epoch, val_acc, val_loss
            save_pytree(model_file, model.state_dict())
            epoch_data = {"epoch": epoch, "results": results,
                          "best_val_acc": best_val_acc,
                          "best_epoch": best_epoch,
                          "best_val_loss": best_val_loss, "done": 0}
            with open(epoch_file, "w") as f:
                json.dump(epoch_data, f)
        if epoch - best_epoch > patience:
            logger.info("early stop after epoch %d", epoch)
            break

    epoch_data = {"epoch": max(best_epoch, start_epoch), "results": results,
                  "best_val_acc": best_val_acc, "best_epoch": best_epoch,
                  "best_val_loss": best_val_loss, "done": 1}
    with open(epoch_file, "w") as f:
        json.dump(epoch_data, f)
    best = model.state_dict()
    if os.path.exists(model_file):
        best = load_pytree(model_file, best)
    return {k: v.detach().clone() for k, v in best.items()}, results


# ---------------------------------------------------------------------------
# Explanation + hard-rationale decoding
# ---------------------------------------------------------------------------

def decode_hard_rationales(word_scores, topk_range=range(5, 85, 5)):
    """Per-k hard-rationale spans from per-word scores (JAX
    ``decode_hard_rationales``, the decode of the reference's
    ``bert_pipeline.py:567-582``): the same token set as the reference for
    every k, each span once and cumulatively, docs shorter than k allowed.
    Returns ``[spans_for_k for k in topk_range]``, each span
    ``{"start_token": i, "end_token": i+1}``."""
    hard = []
    out = []
    order = np.argsort(word_scores)[::-1]
    for k in topk_range:
        for idx in order[len(hard):min(k, len(order))]:
            hard.append({"start_token": int(idx),
                         "end_token": int(idx) + 1})
        out.append(list(hard))
    return out


def explain_test_split(params: Mapping[str, Tensor], cfg: BertConfig,
                       test: List[Annotation], interned,
                       documents: Dict[str, str], classes: Dict[str, int],
                       tokenizer, output_dir: str,
                       method: str = "transformer_attribution",
                       batch_size: int = 16,
                       topk_range=range(5, 85, 5),
                       write_latex: bool = True,
                       write_soft: bool = True,
                       matmul_precision: str = "float32",
                       device="cuda") -> List[str]:
    """Explain every test annotation on ``device`` and write the per-k
    hard-rationale result files and the ground-truth / counterfactual
    LaTeX heatmaps (JAX ``explain_test_split``, the reference's :439-585).
    Returns the result files' paths. ``write_soft`` adds the per-word
    ``soft_rationale_predictions`` (zero past the truncated encoding) that
    the scorer's soft metrics read. ``tokenizer`` needs
    ``convert_ids_to_tokens``."""
    check_explain_supported(cfg, method, matmul_precision)
    call_name, variant, m_start_layer = METHOD_TABLE[method]
    explainer = BertExplainer(params, cfg, device, variant=variant,
                              **explain_precision(matmul_precision))
    eval_step = make_eval_step(cfg)
    folder = os.path.join(output_dir, METHOD_FOLDER[method])
    os.makedirs(folder, exist_ok=True)
    paths = [os.path.join(folder, f"identifier_results_{k}.json")
             for k in topk_range]
    files = [open(p, "w") for p in paths]
    skw = {} if m_start_layer is None else {"start_layer": m_start_layer}

    n_cls = len(classes)
    try:
        for s in range(0, len(test), batch_size):
            anns = test[s:s + batch_size]
            ids, mask, tgt = _batch_arrays(anns, interned, classes)
            logits = eval_step(explainer.model, ids, mask).cpu().numpy()
            cam_t = explainer.explain(ids, mask, indices=tgt,
                                      method=call_name, **skw)
            cam_t = np.clip(cam_t.cpu().numpy(), 0, None)
            # the counterfactual map is read only by the LaTeX heatmaps: a
            # second explain pass per batch, skipped without them
            if write_latex and n_cls == 2 and method in (
                    "transformer_attribution", "partial_lrp",
                    "attn_gradcam", "lrp"):
                cam_cf = explainer.explain(ids, mask, indices=1 - tgt,
                                           method=call_name, **skw)
                cam_cf = np.clip(cam_cf.cpu().numpy(), 0, None)
            else:
                cam_cf = None

            for b, ann in enumerate(anns):
                j = s + b
                doc_name = docid_of(ann)
                doc_words = documents[doc_name].split()
                length = int(mask[b].sum())
                wordpieces = tokenizer.convert_ids_to_tokens(
                    ids[b][:length].tolist())
                classification = "neg" if tgt[b] == 0 else "pos"
                correct = int(logits[b].argmax() == tgt[b])
                if write_latex:
                    render.generate_latex(
                        wordpieces, cam_t[b][:length],
                        os.path.join(folder,
                                     f"{j}_GT_{classification}_{correct}.tex"))
                    if cam_cf is not None:
                        render.generate_latex(
                            wordpieces, cam_cf[b][:length],
                            os.path.join(folder, f"{j}_CF.tex"))
                word_scores = render.scores_per_word_from_scores_per_token(
                    doc_words, wordpieces, cam_t[b][:length])
                soft = None
                if write_soft:
                    soft = np.zeros(len(doc_words))
                    soft[:len(word_scores)] = word_scores
                    soft = soft.tolist()
                per_k = decode_hard_rationales(word_scores, topk_range)
                for fi, k in enumerate(topk_range):
                    rat = {"docid": doc_name,
                           "hard_rationale_predictions": per_k[fi]}
                    if soft is not None:
                        rat["soft_rationale_predictions"] = soft
                    # the reference writes the docid as annotation_id
                    # (:575), right only where they coincide (movies); the
                    # scorer joins on annotation_id, so write the real one
                    files[fi].write(json.dumps({
                        "annotation_id": ann.annotation_id,
                        "rationales": [rat],
                    }) + "\n")
    finally:
        for f in files:
            f.close()
    return paths


def write_ground_truth_latex(test: List[Annotation],
                             interned, documents: Dict[str, str], tokenizer,
                             output_dir: str) -> None:
    """Green ground-truth heatmaps (JAX ``write_ground_truth_latex``, the
    reference's method == "ground_truth", :537-548)."""
    folder = os.path.join(output_dir, METHOD_FOLDER["ground_truth"])
    os.makedirs(folder, exist_ok=True)
    for j, ann in enumerate(test):
        doc_name = docid_of(ann)
        enc = interned[doc_name]
        length = int(np.asarray(enc["attention_mask"]).sum())
        wordpieces = tokenizer.convert_ids_to_tokens(
            np.asarray(enc["input_ids"])[:length].tolist())
        words = render.get_input_words(documents[doc_name].split(),
                                       wordpieces)
        cam = np.zeros(len(words))
        for ev in evidence_group_of(ann):
            if ev.start_token >= len(cam):
                break
            cam[ev.start_token:ev.end_token] = 1
        render.generate_latex(words, cam,
                              os.path.join(folder, f"visual_results_{j}.tex"),
                              color="green")


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_pipeline(data_dir: str, output_dir: str, model_params: dict,
                 method: str = "transformer_attribution",
                 pretrained: Optional[str] = None,
                 write_latex: bool = True, seed: int = 12345,
                 matmul_precision: str = "float32", device="cuda"):
    """The reference's ``main()`` (:213-585), as JAX ``run_pipeline``: load
    the data, tokenize and cache, train (or resume), explain the test split
    and decode rationales on ``device``. ``model_params["bert_vocab"]`` is
    a local tokenizer directory (``transformers.BertTokenizerFast``, read
    offline); ``pretrained`` a local HF checkpoint (``load_bert_checkpoint``),
    else the weights are drawn from ``seed`` on a CPU generator. An explain
    stage the port does not run raises before any work."""
    device = _resolve_device(device)
    ec = model_params["evidence_classifier"]
    classes = {c: i for i, c in enumerate(ec["classes"])}
    cfg = BertConfig(num_labels=len(classes))
    check_explain_supported(cfg, method, matmul_precision)
    from transformers import BertTokenizerFast

    os.makedirs(output_dir, exist_ok=True)
    train, val, test = load_datasets(data_dir)
    docids = set(ev.docid for ann in (*train, *val, *test)
                 for ev in ann.all_evidences())
    documents = load_documents(data_dir, docids)
    logger.info("loaded %d documents", len(documents))

    tokenizer = BertTokenizerFast.from_pretrained(model_params["bert_vocab"])
    interned = intern_documents_bert(
        documents, tokenizer, model_params["max_length"],
        cache_path=os.path.join(output_dir, "preprocessed.pkl"))

    if pretrained:
        from transformer_explainability_torch.params.convert import (
            load_bert_checkpoint)
        params = {k: v.to(device) for k, v in
                  load_bert_checkpoint(pretrained, cfg).items()}
    else:
        params = bert_mod.init_params(
            cfg, generator=torch.Generator().manual_seed(seed), device=device)

    params, results = train_classifier(
        params, cfg, train, val, interned, classes, output_dir,
        batch_size=ec["batch_size"], epochs=ec["epochs"],
        patience=ec["patience"], lr=ec["lr"],
        max_grad_norm=ec.get("max_grad_norm"), seed=seed, device=device)

    if write_latex:
        write_ground_truth_latex(test, interned, documents, tokenizer,
                                 output_dir)
    paths = explain_test_split(params, cfg, test, interned, documents,
                               classes, tokenizer, output_dir, method,
                               batch_size=ec.get("batch_size", 16),
                               write_latex=write_latex,
                               matmul_precision=matmul_precision,
                               device=device)
    return params, results, paths


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="ERASER BERT pipeline on the card: fine-tune, explain, "
                    "decode hard rationales")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--model_params", required=True,
                        help="JSON task config in the reference BERT_params "
                             "schema (e.g. configs/movies_bert.json); its "
                             "bert_vocab must be a local tokenizer directory")
    parser.add_argument("--method", default="transformer_attribution",
                        choices=sorted(METHOD_TABLE))
    parser.add_argument("--pretrained", default=None,
                        help="local HF checkpoint directory or file to "
                             "initialise from")
    parser.add_argument("--no_latex", action="store_true")
    parser.add_argument("--matmul_precision", default="float32",
                        choices=["float32", "tensorfloat32", "bfloat16"],
                        help="explain-stage precision: float32 is exact "
                             "FP32 (plain layers + the rollout kernel), "
                             "bfloat16 the BERT layer kernels for "
                             "transformer_attribution and the plain layers "
                             "in bf16 for the other methods; tensorfloat32 "
                             "runs the other methods and raises for "
                             "transformer_attribution (no kernel mode for "
                             "its bf16x3 rules yet)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    with open(args.model_params) as f:
        model_params = json.load(f)
    logger.info("params: %s", json.dumps(model_params, indent=2,
                                         sort_keys=True))
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    run_pipeline(args.data_dir, args.output_dir, model_params, args.method,
                 pretrained=args.pretrained, write_latex=not args.no_latex,
                 matmul_precision=args.matmul_precision, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
