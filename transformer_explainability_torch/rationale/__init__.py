"""ERASER rationale-benchmark stack (data, metrics, pipeline, rendering).

Port of ``transformer_explainability_torch/rationale/``: jsonl annotation
loading (:mod:`.data`), the full scorer (:mod:`.metrics`), LaTeX heatmaps
and wordpiece-to-word scores (:mod:`.render`) and the end-to-end fine-tune
+ explain + hard-rationale pipeline on the card (:mod:`.pipeline`). The
port keeps its own copies of the modules that import no JAX there.
"""

from transformer_explainability_torch.rationale.data import (  # noqa: F401
    Annotation, Evidence, annotations_from_jsonl, annotations_to_jsonl,
    load_datasets, load_documents, load_flattened_documents, load_jsonl,
    write_jsonl)
