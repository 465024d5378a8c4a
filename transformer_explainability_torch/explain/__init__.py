from transformer_explainability_torch.explain.generator import (  # noqa: F401
    Explainer, explain_batch, make_explain_fn)
