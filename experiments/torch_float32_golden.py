"""Write the port's default float32 outputs on the CPU, for the bitwise
tests of ``tests/test_torch_vit_precisions.py`` and
``tests/test_torch_bert_precisions.py``.

Every ViT and BERT method (and ``transformer_attribution`` with ``lrp`` and
with α = 2) of the port at its float32 preset, on the tests' small configs:
weights from JAX's ``init_params(PRNGKey(0))`` in float32 through the
port's converters, inputs from a numpy seed. Run it against a checkout of
the commit whose outputs are the reference (``--root``), e.g. the parent
unpacked with ``git archive`` under ``build/``:

    python experiments/torch_float32_golden.py --root build/parent \\
        --out tests/golden/torch_float32_paths.npz
"""

import argparse
import os
import sys

import numpy as np

SMALL_VIT = dict(img_size=64, patch_size=16, embed_dim=24, depth=3,
                 num_heads=4, num_classes=10)
SMALL_BERT = dict(vocab_size=97, hidden_size=24, num_layers=3, num_heads=4,
                  intermediate_size=48, max_position_embeddings=64,
                  num_labels=4)


def vit_inputs():
    return np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)


def bert_inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(5, SMALL_BERT["vocab_size"], size=(2, 21))
    mask = (np.arange(21)[None, :] < np.array([21, 13])[:, None]).astype(
        np.float32)
    return ids, mask


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import jax
    jax.config.update("jax_platforms", "cpu")
    from transformer_explainability_tpu.models import bert as jbert
    from transformer_explainability_tpu.models import vit as jvit
    from transformer_explainability_torch import BertExplainer, Explainer
    from transformer_explainability_torch.explain import bert_generator
    from transformer_explainability_torch.explain.generator import METHODS
    from transformer_explainability_torch.models.bert import BertConfig
    from transformer_explainability_torch.models.vit import ViTConfig
    from transformer_explainability_torch.params.convert import (
        bert_params_from_jax, vit_params_from_jax)

    def f32(tree):
        return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), tree)

    out = {}
    tree = f32(jvit.init_params(jax.random.PRNGKey(0),
                                jvit.ViTConfig(**SMALL_VIT)))
    sd = vit_params_from_jax(tree, ViTConfig(**SMALL_VIT))
    imgs = vit_inputs()
    ex = Explainer(sd, ViTConfig(**SMALL_VIT), "cpu")
    for m in METHODS:
        out[f"vit_{m}"] = ex.explain(imgs, [3, -1], method=m).numpy()
    out["vit_alpha2"] = ex.explain(imgs, [3, -1], alpha=2.0).numpy()
    out["vit_lrp"] = Explainer(sd, ViTConfig(**SMALL_VIT), "cpu",
                               variant="lrp").explain(imgs, [3, -1]).numpy()

    tree = f32(jbert.init_params(jax.random.PRNGKey(0),
                                 jbert.BertConfig(**SMALL_BERT)))
    sd = bert_params_from_jax(tree, BertConfig(**SMALL_BERT))
    ids, mask = bert_inputs()
    ex = BertExplainer(sd, BertConfig(**SMALL_BERT), "cpu")
    for m in bert_generator.METHODS:
        out[f"bert_{m}"] = ex.explain(ids, mask, [1, -1], method=m,
                                      start_layer=0).numpy()
    out["bert_alpha2"] = ex.explain(ids, mask, [1, -1], alpha=2.0,
                                    start_layer=0).numpy()
    out["bert_lrp"] = BertExplainer(
        sd, BertConfig(**SMALL_BERT), "cpu", variant="lrp").explain(
        ids, mask, [1, -1], start_layer=0).numpy()
    np.savez_compressed(args.out, **out)
    print(f"wrote {len(out)} arrays to {args.out}")


if __name__ == "__main__":
    main()
