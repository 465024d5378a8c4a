"""The port's ERASER stack against the JAX package, on the CPU: data and
render copies, the scorer (with scikit-learn present and hidden), BERT's
training forward, the pipeline's train step and its precision checks, in
float64 (the pipeline end to end: ``test_torch_rationale_pipeline.py``).

Same weights both ways (JAX ``init_params`` exported with the port's
converter), the same synthetic ERASER layout (documents and
``{train,val,test}.jsonl`` written from a seed) and the same local
wordpiece vocabulary (``transformers.BertTokenizerFast`` over a written
``vocab.txt``; nothing is downloaded). JAX draws its dropout masks from
``jax.random``, the port from a ``torch.Generator``, so the comparisons run
at dropout 0, and the dropout sites are held with a deterministic mask put
in on both sides for the test. Tolerance rtol 1e-8 / atol 1e-12.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_rationale_common import (ATOL, MAX_LEN, PIPE, RTOL, SMALL,
                                    dataset, tokenizer, weights)
from transformer_explainability_tpu.models import bert as jbert
from transformer_explainability_tpu.rationale import data as jdata
from transformer_explainability_tpu.rationale import metrics as jmetrics
from transformer_explainability_tpu.rationale import pipeline as jpl
from transformer_explainability_tpu.rationale import render as jrender
from transformer_explainability_torch.models import bert as tbert
from transformer_explainability_torch.models.bert import (
    BertConfig, BertForSequenceClassification)
from transformer_explainability_torch.params.convert import (
    bert_params_from_jax)
from transformer_explainability_torch.rationale import data as tdata
from transformer_explainability_torch.rationale import metrics as tmetrics
from transformer_explainability_torch.rationale import pipeline as tpl
from transformer_explainability_torch.rationale import render as trender


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _as_tuple(ann):
    return json.dumps(jdata._to_jsonable(ann), sort_keys=True)


def test_data_round_trip_and_loaders_match_jax(tmp_path):
    anns = dataset(tmp_path)
    out_j, out_t = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jdata.annotations_to_jsonl(
        jdata.annotations_from_jsonl(str(tmp_path / "test.jsonl")), str(out_j))
    tdata.annotations_to_jsonl(anns, str(out_t))
    assert out_j.read_text() == out_t.read_text()
    for split_j, split_t in zip(jdata.load_datasets(str(tmp_path)),
                                tdata.load_datasets(str(tmp_path))):
        assert [_as_tuple(a) for a in split_j] == \
            [_as_tuple(a) for a in split_t]
    for name in ("load_documents", "load_flattened_documents",
                 "load_sentence_documents"):
        assert getattr(jdata, name)(str(tmp_path)) == \
            getattr(tdata, name)(str(tmp_path)), name
    rows = [{"a": 1, "b": [1, 2]}, {"c": "x"}]
    tdata.write_jsonl(rows, str(tmp_path / "rows.jsonl"))
    assert jdata.load_jsonl(str(tmp_path / "rows.jsonl")) == rows
    docs = tdata.load_sentence_documents(str(tmp_path))
    assert tdata.intern_documents(docs, {"<unk>": 0, "good": 1}, "<unk>") == \
        jdata.intern_documents(docs, {"<unk>": 0, "good": 1}, "<unk>")


def test_render_matches_jax(tmp_path):
    tok = tokenizer(tmp_path)
    text = "an unforgettable masterpiece with breathtaking cinematography zzz"
    words = text.split()
    wordpieces = tok.convert_ids_to_tokens(tok(text)["input_ids"])
    scores = np.random.RandomState(0).rand(len(wordpieces))
    np.testing.assert_array_equal(
        trender.scores_per_word_from_scores_per_token(words, wordpieces,
                                                      scores),
        jrender.scores_per_word_from_scores_per_token(words, wordpieces,
                                                      scores))
    assert trender.get_input_words(words, wordpieces) == \
        jrender.get_input_words(words, wordpieces)
    for color, att in (("red", scores), ("green", np.ones(len(scores))),
                       ("red", scores * 0.001)):
        trender.generate_latex(wordpieces, att, str(tmp_path / "t.tex"),
                               color=color)
        jrender.generate_latex(wordpieces, att, str(tmp_path / "j.tex"),
                               color=color)
        assert (tmp_path / "t.tex").read_text() == \
            (tmp_path / "j.tex").read_text()
    signed = np.linspace(-1, 1, len(wordpieces))
    assert trender.render_text_heatmap_html(wordpieces, signed, "pos", "neg",
                                            0.7, "pos") == \
        jrender.render_text_heatmap_html(wordpieces, signed, "pos", "neg",
                                         0.7, "pos")


def test_decode_hard_rationales_matches_jax():
    rng = np.random.RandomState(0)
    for n in (97, 7, 40):
        ws = rng.rand(n)
        ws[::5] = 0.0                                   # ties
        assert tpl.decode_hard_rationales(ws) == \
            jpl.decode_hard_rationales(ws)


def _results(anns, flat, k=7, seed=1):
    """Synthetic hard + soft predictions, classifications and the
    faithfulness fields, overlapping the gold spans about half the time."""
    rng = np.random.RandomState(seed)
    results = []
    for ann in anns:
        docid = ann.annotation_id
        L = len(flat[docid])
        (ev,) = next(iter(ann.evidences))
        scores = rng.rand(L)
        scores[ev.start_token:ev.start_token + 3] += 1.0
        top = np.argsort(scores)[::-1][:k]
        p = rng.rand() * 0.5 + 0.4
        cls = ann.classification if rng.rand() < 0.8 else (
            "POS" if ann.classification == "NEG" else "NEG")
        other = "NEG" if cls == "POS" else "POS"
        results.append({
            "annotation_id": ann.annotation_id,
            "rationales": [{
                "docid": docid,
                "hard_rationale_predictions": [
                    {"start_token": int(t), "end_token": int(t) + 1}
                    for t in top],
                "soft_rationale_predictions": scores.tolist(),
            }],
            "classification": cls,
            "classification_scores": {cls: p, other: 1 - p},
            "comprehensiveness_classification_scores": {
                cls: p * 0.5, other: 1 - p * 0.5},
            "sufficiency_classification_scores": {
                cls: p * 0.9, other: 1 - p * 0.9},
            "thresholded_scores": [
                {"threshold": t,
                 "comprehensiveness_classification_scores": {
                     cls: p * (1 - t), other: 1 - p * (1 - t)},
                 "sufficiency_classification_scores": {
                     cls: p * t, other: 1 - p * t}}
                for t in (0.01, 0.05, 0.1, 0.2, 0.5)],
        })
    return results


def _hard_only(results):
    return [{"annotation_id": r["annotation_id"], "rationales": [{
        "docid": r["rationales"][0]["docid"],
        "hard_rationale_predictions":
            r["rationales"][0]["hard_rationale_predictions"]}]}
        for r in results]


def test_score_results_matches_jax(tmp_path):
    dataset(tmp_path)
    anns_t = tdata.annotations_from_jsonl(str(tmp_path / "test.jsonl"))
    anns_j = jdata.annotations_from_jsonl(str(tmp_path / "test.jsonl"))
    flat = tdata.load_flattened_documents(str(tmp_path))
    results = _results(anns_t, flat)
    got = tmetrics.score_results(results, anns_t, str(tmp_path),
                                 iou_thresholds=(0.1, 0.5))
    want = jmetrics.score_results(results, anns_j, str(tmp_path),
                                  iou_thresholds=(0.1, 0.5))
    assert {"iou_scores", "rationale_prf", "token_prf",
            "token_soft_metrics", "classification_scores"} <= set(got)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    # the CLI writes the same scores
    res_path = tmp_path / "results.jsonl"
    tdata.write_jsonl(results, str(res_path))
    score_file = tmp_path / "scores.json"
    tmetrics.main(["--data_dir", str(tmp_path), "--split", "test",
                   "--results", str(res_path), "--score_file",
                   str(score_file)])
    jscores = jmetrics.score_results(results, anns_j, str(tmp_path))
    assert json.loads(score_file.read_text()) == json.loads(
        json.dumps(jscores))


def test_hard_scores_run_without_sklearn(tmp_path, monkeypatch):
    """With scikit-learn hidden the hard-rationale scores are the same; the
    soft and classification scores are the ones that import it."""
    dataset(tmp_path)
    anns = tdata.annotations_from_jsonl(str(tmp_path / "test.jsonl"))
    flat = tdata.load_flattened_documents(str(tmp_path))
    results = _results(anns, flat)
    hard = _hard_only(results)
    want = tmetrics.score_results(hard, anns, str(tmp_path))
    for name in [m for m in sys.modules if m == "sklearn"
                 or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    got = tmetrics.score_results(hard, anns, str(tmp_path))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert set(got) == {"iou_scores", "rationale_prf", "token_prf"}
    with pytest.raises(ImportError):
        tmetrics.score_results(results, anns, str(tmp_path))


def _model(sd, fields=SMALL):
    model = BertForSequenceClassification(BertConfig(**fields),
                                          dtype=torch.float64)
    model.load_state_dict(sd)
    return model


def _token_batch(B=3, S=40, seed=4):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, SMALL["vocab_size"], size=(B, S))
    lengths = np.array([S, 23, 31][:B])
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    return ids, mask


def _stand_in_mask(shape):
    """A dropout mask that depends only on the per-example shape."""
    n = int(np.prod(shape))
    return (np.arange(n).reshape(shape) * 2654435761) % 7 != 3


def _jax_train_forward_grads(jcfg, params, ids, mask, r, rate):
    def out(p):
        logits = jax.vmap(lambda i, m: jbert.train_forward(
            p, i, m, jcfg, jax.random.PRNGKey(0), hidden_dropout=rate,
            attn_dropout=rate))(jnp.asarray(ids), jnp.asarray(mask))
        return (logits * r).sum(), logits
    (_, logits), grads = jax.jit(jax.value_and_grad(out, has_aux=True))(
        params)
    return np.asarray(logits), grads


@pytest.mark.parametrize("dropout", ["off", "stand-in"])
def test_bert_train_forward_matches_jax(dropout, monkeypatch):
    """Logits and parameter gradients of the training forward equal JAX's:
    at dropout 0, and with a deterministic mask put in at every dropout
    site on both sides (which holds the 3·L + 2 sites' placement)."""
    jcfg, params, sd = weights()
    ids, mask = _token_batch()
    r = np.random.RandomState(5).randn(ids.shape[0], SMALL["num_labels"])
    rate = 0.0
    sites = []
    if dropout == "stand-in":
        rate = 0.25

        def jdrop(x, rate, key):
            return jnp.where(jnp.asarray(_stand_in_mask(x.shape)),
                             x / (1.0 - rate), 0.0)

        def tdrop(x, rate, generator):
            sites.append(tuple(x.shape[1:]))
            return torch.where(torch.as_tensor(_stand_in_mask(x.shape[1:])),
                               x / (1.0 - rate), 0.0)

        monkeypatch.setattr(jbert, "_dropout", jdrop)
        monkeypatch.setattr(tbert, "_dropout", tdrop)
    jlogits, jgrads = _jax_train_forward_grads(jcfg, params, ids, mask,
                                               jnp.asarray(r), rate)
    model = _model(sd)
    logits = tbert.train_forward(model, torch.tensor(ids), torch.tensor(mask),
                                 None, hidden_dropout=rate, attn_dropout=rate)
    (logits * torch.tensor(r)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=RTOL,
                               atol=ATOL)
    want = bert_params_from_jax(jax.tree.map(np.asarray, jgrads),
                                BertConfig(**SMALL))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if dropout == "stand-in":
        L, S, D, h = (SMALL["num_layers"], ids.shape[1],
                      SMALL["hidden_size"], SMALL["num_heads"])
        assert sites == [(S, D)] + [(h, S, S), (S, D), (S, D)] * L + [(D,)]
        plain = tbert.train_forward(_model(sd), torch.tensor(ids),
                                    torch.tensor(mask), None, 0.0, 0.0)
        assert not torch.allclose(plain, logits)


def test_bert_dropout_draws_from_the_generator():
    x = torch.ones(4, 1000, dtype=torch.float64)
    a = tbert._dropout(x, 0.1, torch.Generator().manual_seed(1))
    b = tbert._dropout(x, 0.1, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.9))
    assert 0.85 < kept.double().mean().item() < 0.95
    assert tbert._dropout(x, 0.0, None) is x


def test_pipeline_train_step_matches_jax():
    """Two steps of the pipeline's train step on JAX's padded batch (three
    rows and a padding row weighing 0): loss, hits and every weight."""
    jcfg, params, sd = weights()
    ids, mask = _token_batch()
    tgt = np.array([0, 1, 1], np.int32)
    ids = np.concatenate([ids, ids[-1:]])
    mask = np.concatenate([mask, mask[-1:]])
    tgt = np.concatenate([tgt, tgt[-1:]])
    w = np.array([1, 1, 1, 0], np.float32)
    lr, clip = 1e-4, 0.05
    tx, jstep = jpl.make_train_step(jcfg, optax.adam(lr), clip, dropout=0.0)
    jstate = tx.init(params)
    model = _model(sd)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = tpl.make_train_step(BertConfig(**SMALL), clip, dropout=0.0)
    for k in range(2):
        params, jstate, jloss, jcorrect = jstep(
            params, jstate, ids, mask, tgt, w, jax.random.PRNGKey(k))
        loss, correct = step(model, opt, ids, mask, tgt, w, None)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        assert correct.item() == float(jcorrect)
    want = bert_params_from_jax(jax.tree.map(np.asarray, params),
                                BertConfig(**SMALL))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_explain_stage_precisions(tmp_path):
    """``bfloat16`` runs the layer kernels' plain versions on the CPU (the
    kernels on a card); ``tensorfloat32`` (bf16x3 rules, no kernel mode)
    and a baseline method at a reduced base raise before any work, on the
    CPU as on the card, naming the ROADMAP item."""
    dataset(tmp_path, n_docs=3)
    tok = tokenizer(tmp_path)
    documents = tdata.load_documents(str(tmp_path))
    interned = tpl.intern_documents_bert(documents, tok, MAX_LEN)
    test = tdata.load_datasets(str(tmp_path))[2]
    classes = {"NEG": 0, "POS": 1}
    sd = tbert.init_params(BertConfig(**PIPE),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    paths = tpl.explain_test_split(sd, BertConfig(**PIPE), test, interned,
                                   documents, classes, tok,
                                   str(tmp_path / "bf16"), batch_size=2,
                                   topk_range=range(5, 10, 5),
                                   matmul_precision="bfloat16", device="cpu")
    rows = tdata.load_jsonl(paths[0])
    assert len(rows) == len(test)
    assert all(np.isfinite(r["rationales"][0]["soft_rationale_predictions"])
               .all() for r in rows)
    for method, prec, item in (
            ("transformer_attribution", "tensorfloat32",
             "ROADMAP B, raw tensorfloat32"),):
        out = tmp_path / f"raise_{prec}"
        with pytest.raises(NotImplementedError, match=item):
            tpl.explain_test_split(sd, BertConfig(**PIPE), test, interned,
                                   documents, classes, tok, str(out),
                                   method=method, matmul_precision=prec,
                                   device="cpu")
        assert not out.exists()
        mp = {"max_length": MAX_LEN, "bert_vocab": str(tmp_path),
              "evidence_classifier": {"classes": ["NEG", "POS"],
                                      "batch_size": 2, "epochs": 1,
                                      "patience": 1, "lr": 1e-5}}
        with pytest.raises(NotImplementedError, match=item):
            tpl.run_pipeline(str(tmp_path), str(out), mp, method,
                             matmul_precision=prec, device="cpu")
        assert not out.exists()
    assert tpl.explain_precision("tensorfloat32") == dict(
        matmul_precision="tensorfloat32", attn_precision="float32",
        mlp_precision="bfloat16")


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    sd = tbert.init_params(BertConfig(**SMALL),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.train_classifier(sd, BertConfig(**SMALL), [], [], {}, {},
                             str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.explain_test_split(sd, BertConfig(**SMALL), [], {}, {}, {}, None,
                               str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.run_pipeline(str(tmp_path), str(tmp_path), {
            "evidence_classifier": {"classes": ["NEG", "POS"]}})
