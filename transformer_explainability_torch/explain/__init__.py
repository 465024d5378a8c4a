from transformer_explainability_torch.explain.generator import (  # noqa: F401
    DIAG_FIELDS, PRECISION_PRESETS, Explainer, explain_batch,
    make_explain_fn, precision_kwargs)
from transformer_explainability_torch.explain.bert_generator import (  # noqa: F401
    BertExplainer)
