"""The port's ERASER pipeline end to end against the JAX package's, in
float64 on the CPU: ``train_classifier`` (epoch results, best weights,
resume), ``explain_test_split`` (hard spans, soft scores, LaTeX) and
``run_pipeline`` on a local vocabulary directory.

Same weights both ways (JAX ``init_params`` exported with the port's
converter), the same synthetic ERASER layout and local wordpiece
vocabulary (``torch_rationale_common``); dropout 0, since the two draw
their masks from different generators. The explain stage's
``transformer_attribution`` rolls out from layer 11, so these cases take a
12-layer tiny BERT. Tolerance rtol 1e-8 / atol 1e-12.
"""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from torch_rationale_common import (ATOL, MAX_LEN, PIPE, RTOL, SMALL,
                                    VOCAB, dataset, tokenizer, weights)
from transformer_explainability_tpu.rationale import data as jdata
from transformer_explainability_tpu.rationale import pipeline as jpl
from transformer_explainability_torch.models import bert as tbert
from transformer_explainability_torch.models.bert import BertConfig
from transformer_explainability_torch.params.convert import (
    bert_params_from_jax)
from transformer_explainability_torch.rationale import data as tdata
from transformer_explainability_torch.rationale import metrics as tmetrics
from transformer_explainability_torch.rationale import pipeline as tpl


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


_NUM = re.compile(r"colorbox\{(?:red|green)!([^}]*)\}")


def _assert_tex_close(a: str, b: str):
    """The same LaTeX text, each color weight (printed as its full float
    repr) within the tolerance."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b)
    np.testing.assert_allclose(np.array(_NUM.findall(a), float),
                               np.array(_NUM.findall(b), float),
                               rtol=RTOL, atol=1e-9)


def test_pipeline_end_to_end_matches_jax(tmp_path):
    """Dropout 0: train_classifier's epoch results and best weights, then
    explain_test_split's result files (hard spans equal, soft predictions
    at rtol 1e-8) and LaTeX heatmaps equal JAX's on the same layout and
    vocabulary; a second train_classifier resumes as done."""
    dataset(tmp_path)
    tok = tokenizer(tmp_path)
    documents = tdata.load_documents(str(tmp_path))
    interned = tpl.intern_documents_bert(documents, tok, MAX_LEN)
    jinterned = jpl.intern_documents_bert(documents, tok, MAX_LEN)
    for d in interned:
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(interned[d][k], jinterned[d][k])
    assert max(int(v["attention_mask"].sum()) for v in interned.values()) \
        == MAX_LEN                                      # truncated
    classes = {"NEG": 0, "POS": 1}
    train_t, val_t, test_t = tdata.load_datasets(str(tmp_path))
    train_j, val_j, test_j = jdata.load_datasets(str(tmp_path))
    for n in (3, 4, 5):                 # JAX's padded batches, bucketed
        for a, b in zip(tpl._padded_batch(test_t[:n], interned, classes),
                        jpl._padded_batch(test_j[:n], jinterned, classes)):
            np.testing.assert_array_equal(a, b)
    jcfg, params, sd = weights(PIPE)
    cfg = BertConfig(**PIPE)
    kw = dict(batch_size=2, epochs=2, patience=1, lr=1e-4, max_grad_norm=1.0,
              dropout=0.0, seed=0)
    out_t, out_j = tmp_path / "out_t", tmp_path / "out_j"
    jparams, jres = jpl.train_classifier(params, jcfg, train_j, val_j,
                                         jinterned, classes, str(out_j), **kw)
    best, res = tpl.train_classifier(sd, cfg, train_t, val_t, interned,
                                     classes, str(out_t), device="cpu", **kw)
    assert res["train_acc"] == jres["train_acc"]
    assert res["val_acc"] == jres["val_acc"]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(res[key], jres[key], rtol=RTOL)
    want = bert_params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    for k, v in best.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    with open(out_t / "classifier" / "epoch_data.json") as f:
        done_t = json.load(f)
    with open(out_j / "classifier" / "epoch_data.json") as f:
        done_j = json.load(f)
    for k in ("epoch", "best_epoch", "best_val_acc", "done"):
        assert done_t[k] == done_j[k], k

    again, res2 = tpl.train_classifier(sd, cfg, train_t, val_t, interned,
                                       classes, str(out_t), device="cpu",
                                       **kw)
    assert res2 == res
    for k in best:
        assert torch.equal(again[k], best[k]), k

    topk = range(5, 15, 5)
    paths_j = jpl.explain_test_split(jparams, jcfg, test_j, jinterned,
                                     documents, classes, tok, str(out_j),
                                     batch_size=6, topk_range=topk)
    paths_t = tpl.explain_test_split(best, cfg, test_t, interned, documents,
                                     classes, tok, str(out_t), batch_size=6,
                                     topk_range=topk, device="cpu")
    for pj, pt in zip(paths_j, paths_t):
        assert os.path.basename(pj) == os.path.basename(pt)
        rows_j = tdata.load_jsonl(pj)
        rows_t = tdata.load_jsonl(pt)
        assert len(rows_t) == len(test_t)
        for rj, rt in zip(rows_j, rows_t):
            assert rt["annotation_id"] == rj["annotation_id"]
            (ratj,), (ratt,) = rj["rationales"], rt["rationales"]
            assert ratt["docid"] == ratj["docid"]
            assert ratt["hard_rationale_predictions"] == \
                ratj["hard_rationale_predictions"]
            np.testing.assert_allclose(
                ratt["soft_rationale_predictions"],
                ratj["soft_rationale_predictions"], rtol=RTOL, atol=ATOL)
    texs = sorted(p for p in os.listdir(out_j / "ours") if p.endswith(".tex"))
    assert texs == sorted(p for p in os.listdir(out_t / "ours")
                          if p.endswith(".tex"))
    assert len(texs) == 2 * len(test_t)                # GT and CF maps
    for name in texs:
        _assert_tex_close((out_t / "ours" / name).read_text(),
                          (out_j / "ours" / name).read_text())
    tpl.write_ground_truth_latex(test_t, interned, documents, tok,
                                 str(out_t))
    jpl.write_ground_truth_latex(test_j, jinterned, documents, tok,
                                 str(out_j))
    for j in range(len(test_t)):
        name = f"ground_truth/visual_results_{j}.tex"
        assert (out_t / name).read_text() == (out_j / name).read_text()
    scores = tmetrics.score_results(tdata.load_jsonl(paths_t[0]), test_t,
                                    str(tmp_path))
    assert 0.0 <= scores["token_prf"]["instance_micro"]["f1"] <= 1.0


@pytest.mark.parametrize("method", ["attn_gradcam", "rollout"])
def test_pipeline_baseline_methods_match_jax(tmp_path, method):
    """A baseline method (lrp-variant rules; rollout from layer 0) through
    explain_test_split on the initial weights: the same files as JAX's."""
    dataset(tmp_path, n_docs=6)
    tok = tokenizer(tmp_path)
    documents = tdata.load_documents(str(tmp_path))
    interned = tpl.intern_documents_bert(documents, tok, MAX_LEN)
    classes = {"NEG": 0, "POS": 1}
    jcfg, params, sd = weights()
    topk = range(5, 10, 5)
    pj = jpl.explain_test_split(
        params, jcfg, jdata.load_datasets(str(tmp_path))[2], interned,
        documents, classes, tok, str(tmp_path / "j"), method=method,
        batch_size=4, topk_range=topk, write_latex=False)
    pt = tpl.explain_test_split(
        sd, BertConfig(**SMALL), tdata.load_datasets(str(tmp_path))[2],
        interned, documents, classes, tok, str(tmp_path / "t"),
        method=method, batch_size=4, topk_range=topk, write_latex=False,
        device="cpu")
    rows_j, rows_t = tdata.load_jsonl(pj[0]), tdata.load_jsonl(pt[0])
    for rj, rt in zip(rows_j, rows_t):
        (ratj,), (ratt,) = rj["rationales"], rt["rationales"]
        assert ratt["hard_rationale_predictions"] == \
            ratj["hard_rationale_predictions"]
        np.testing.assert_allclose(ratt["soft_rationale_predictions"],
                                   ratj["soft_rationale_predictions"],
                                   rtol=RTOL, atol=ATOL)


def test_run_pipeline_matches_the_stages(tmp_path, monkeypatch):
    """``run_pipeline`` on a local vocabulary directory (no download) runs
    the stages it is made of: its result files are those of the stages run
    one by one from the same seed."""
    dataset(tmp_path, n_docs=6)
    (tmp_path / "vocab").mkdir()
    (tmp_path / "vocab" / "vocab.txt").write_text("\n".join(VOCAB))
    mp = {"max_length": MAX_LEN, "bert_vocab": str(tmp_path / "vocab"),
          "evidence_classifier": {"classes": ["NEG", "POS"],
                                  "batch_size": 2, "epochs": 1,
                                  "patience": 1, "lr": 1e-5,
                                  "max_grad_norm": 1}}
    small = BertConfig(**PIPE)
    # BERT-base's width is the card's; the CPU run takes the small config
    monkeypatch.setattr(tpl, "BertConfig", lambda num_labels: dataclasses.
                        replace(small, num_labels=num_labels))
    params, results, paths = tpl.run_pipeline(
        str(tmp_path), str(tmp_path / "run"), mp, seed=3, device="cpu")
    assert (tmp_path / "run" / "preprocessed.pkl").exists()
    assert len(results["train_loss"]) == 1
    assert len(os.listdir(tmp_path / "run" / "ground_truth")) == 6
    rows = tdata.load_jsonl(paths[0])
    assert len(rows) == 6
    tok = tokenizer(tmp_path)
    documents = tdata.load_documents(str(tmp_path))
    interned = tpl.intern_documents_bert(documents, tok, MAX_LEN)
    train, val, test = tdata.load_datasets(str(tmp_path))
    sd = tbert.init_params(small, generator=torch.Generator().manual_seed(3),
                           device="cpu")
    best, res = tpl.train_classifier(sd, small, train, val, interned,
                                     {"NEG": 0, "POS": 1},
                                     str(tmp_path / "stages"), batch_size=2,
                                     epochs=1, patience=1, lr=1e-5,
                                     max_grad_norm=1, seed=3, device="cpu")
    assert res == results
    for k in best:
        assert torch.equal(best[k], params[k]), k
