from transformer_explainability_torch.explain.generator import (  # noqa: F401
    PRECISION_PRESETS, Explainer, explain_batch, make_explain_fn,
    precision_kwargs)
