"""Shared inputs of the port's ERASER tests: the small BERT configs, a
local wordpiece vocabulary, a synthetic ERASER layout written from a seed,
and the same weights for JAX and the port."""

import jax
import jax.numpy as jnp
import numpy as np

from transformer_explainability_tpu.models import bert as jbert
from transformer_explainability_torch.models.bert import BertConfig
from transformer_explainability_torch.params.convert import (
    bert_params_from_jax)
from transformer_explainability_torch.rationale import data as tdata

RTOL, ATOL = 1e-8, 1e-12
SMALL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             intermediate_size=64, max_position_embeddings=64, num_labels=2)
# the pipeline's transformer_attribution rolls out from layer 11 (JAX's
# and the reference's start layer), so its end-to-end cases take 12 layers
PIPE = dict(SMALL, num_layers=12)
MAX_LEN = 48
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "good", "bad", "movie", "plot", "actor", "the", "a", "was", "film",
         "scene", "what", "is", "sentiment", "of", "this", "review", "?",
         "great", "##ly", "fun", "un", "##forget", "##table",
         "masterpiece", "with", "breath", "##taking", "an", "cinema",
         "##tog", "##raphy"]
# document words: some split into two or three wordpieces
WORDS = ["good", "bad", "movie", "plot", "actor", "the", "a", "was", "film",
         "scene", "greatly", "unforgettable", "breathtaking",
         "cinematography"]


def tokenizer(tmp_path):
    from transformers import BertTokenizerFast
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(VOCAB))
    return BertTokenizerFast(vocab_file=str(p), do_lower_case=True)


def dataset(tmp_path, n_docs=12, doc_len=40, seed=0):
    """Synthetic ERASER layout (docs/ + {train,val,test}.jsonl), written by
    the port's data module; the documents run past MAX_LEN wordpieces."""
    rng = np.random.RandomState(seed)
    docs_dir = tmp_path / "docs"
    docs_dir.mkdir(exist_ok=True)
    anns = []
    for i in range(n_docs):
        words = [WORDS[rng.randint(len(WORDS))] for _ in range(doc_len)]
        text = (" ".join(words[:doc_len // 2]) + "\n"
                + " ".join(words[doc_len // 2:]))
        docid = f"doc_{i}"
        (docs_dir / docid).write_text(text)
        start = int(rng.randint(0, doc_len - 6))
        ev = tdata.Evidence(text=" ".join(words[start:start + 5]),
                            docid=docid, start_token=start,
                            end_token=start + 5, start_sentence=0,
                            end_sentence=1)
        anns.append(tdata.Annotation(
            annotation_id=docid, query="what is the sentiment of this review?",
            evidences=frozenset([(ev,)]),
            classification="POS" if i % 2 == 0 else "NEG"))
    k = n_docs // 3
    for split, sub in (("train", anns[:k]), ("val", anns[k:2 * k]),
                       ("test", anns)):
        tdata.annotations_to_jsonl(sub, str(tmp_path / f"{split}.jsonl"))
    return anns


def weights(fields=SMALL, key=0):
    """(JAX config, JAX f64 pytree, port f64 state dict) of the same init."""
    jcfg = jbert.BertConfig(**fields)
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float64),
                        jbert.init_params(jax.random.PRNGKey(key), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), bert_params_from_jax(
        tree, BertConfig(**fields))
