"""Token-heatmap LaTeX rendering + wordpiece→word score mapping.

A copy of ``transformer_explainability_tpu/rationale/render.py`` (the port
imports nothing of the JAX package). Behavioral port of the helpers
embedded in reference
``BERT_rationale_benchmark/models/pipeline/bert_pipeline.py``:
``generate`` (:49-84), ``clean_word`` (:87-94),
``scores_per_word_from_scores_per_token`` (:96-138) and
``get_input_words`` (:140-166). Pure numpy.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

SPECIAL_TOKENS = ("[CLS]", "[SEP]", "[UNK]", "[PAD]")

_LATEX_PREAMBLE = r"""\documentclass[varwidth=150mm]{standalone}
\special{papersize=210mm,297mm}
\usepackage{color}
\usepackage{tcolorbox}
\usepackage{CJK}
\usepackage{adjustbox}
\tcbset{width=0.9\textwidth,boxrule=0pt,colback=red,arc=0pt,auto outer arc,left=0pt,right=0pt,boxsep=5pt}
\begin{document}
\begin{CJK*}{UTF8}{gbsn}"""

_LATEX_POSTAMBLE = "\\end{CJK*}\n\\end{document}"


def clean_word(words: Sequence[str]) -> List[str]:
    out = []
    for word in words:
        for ch in ["\\", "%", "&", "^", "#", "_", "{", "}"]:
            if ch in word:
                word = word.replace(ch, "\\" + ch)
        out.append(word)
    return out


def generate_latex(text_list: Sequence[str], attention, latex_file: str,
                   color: str = "red") -> None:
    """Write a LaTeX doc coloring each token by its (0-100 rescaled)
    attention; wordpieces ('##x') attach to the previous box without a space
    (reference ``bert_pipeline.py:49-84``)."""
    att = np.asarray(attention, np.float64)[:len(text_list)]
    if att.max() == att.min():
        att = np.zeros_like(att)
    else:
        att = 100.0 * (att - att.min()) / (att.max() - att.min())
    att = np.where(att < 1, 0.0, att)
    words = clean_word([t.replace("$", "") for t in text_list])
    parts = [_LATEX_PREAMBLE, "\n",
             r"{\setlength{\fboxsep}{0pt}\colorbox{white!0}{"
             r"\parbox{0.9\textwidth}{", "\n"]
    for word, a in zip(words, att.tolist()):
        if "\\#\\#" in word:
            token = word.replace("\\#\\#", "")
            parts.append("\\colorbox{%s!%s}{\\strut %s}" % (color, a, token))
        else:
            parts.append(" \\colorbox{%s!%s}{\\strut %s}" % (color, a, word))
    parts.append("\n}}}\n")
    parts.append(_LATEX_POSTAMBLE)
    with open(latex_file, "w") as f:
        f.write("".join(parts))


def _signed_color(score: float) -> str:
    """The hsl color ramp of the colored-text surface the reference's
    ``BERT_explainability.ipynb`` renders with (captum
    ``visualization._get_color``): green for positive relevance, red for
    negative, lightness falling with |score|."""
    s = float(min(1.0, max(-1.0, score)))
    if s >= 0:
        return "hsl(120, 75%%, %d%%)" % (100 - int(50 * s))
    return "hsl(0, 75%%, %d%%)" % (100 - int(-40 * s))


def _html_escape(t: str) -> str:
    return (t.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def render_text_heatmap_html(tokens: Sequence[str], scores,
                             true_label: str = "", pred_label: str = "",
                             pred_prob: float = None,
                             attr_label: str = "") -> str:
    """Per-token relevance as a self-contained HTML snippet — the repo's
    analog of the captum ``visualize_text`` record the reference's
    ``BERT_explainability.ipynb`` ships as its BERT demo surface (cell 6:
    one table row of legend columns + tokens highlighted green/red by
    signed score).

    ``scores`` are signed values in [-1, 1] — the notebook's contract:
    min-max-normalized relevance, sign-flipped when the rendered class is
    the negative one (higher relevance = more negative evidence). The
    renderer clips but never rescales, so the artifact is a pure function
    of its inputs (golden-testable byte-exact). Wordpiece tokens ('##x')
    join their predecessor without a space, mirroring
    :func:`generate_latex`."""
    scores = np.asarray(scores, np.float64)[:len(tokens)]
    parts = []
    for tok, sc in zip(tokens, scores.tolist()):
        text = _html_escape(tok)
        joiner = ""
        if text.startswith("##"):
            text = text[2:]
        else:
            joiner = " "
        parts.append(
            '%s<mark style="background-color: %s; opacity:1.0; '
            'line-height:1.75"><font color="black">%s</font></mark>'
            % (joiner, _signed_color(sc), text))
    word_html = "".join(parts).lstrip()
    prob = "" if pred_prob is None else " (%.2f)" % float(pred_prob)
    cells = [
        "<td><text style=\"padding-right:2em\"><b>%s</b></text></td>"
        % _html_escape(true_label),
        "<td><text style=\"padding-right:2em\"><b>%s%s</b></text></td>"
        % (_html_escape(pred_label), prob),
        "<td><text style=\"padding-right:2em\"><b>%s</b></text></td>"
        % _html_escape(attr_label),
        "<td><text style=\"padding-right:2em\"><b>%.2f</b></text></td>"
        % float(scores.sum()),
        "<td>%s</td>" % word_html,
    ]
    header = ("<tr><th>True Label</th><th>Predicted Label</th>"
              "<th>Attribution Label</th><th>Attribution Score</th>"
              "<th>Word Importance</th></tr>")
    return ("<table width: 100%%>%s<tr>%s</tr></table>"
            % (header, "".join(cells)))


def _chars_and_words(doc_words: Sequence[str], wordpieces: Sequence[str]):
    """Greedy character realignment of wordpieces onto whitespace words —
    the reference's char-accumulation scheme (:103-137)."""
    pieces = [w.replace("##", "") for w in wordpieces]
    chars = []
    for w in pieces:
        if w in SPECIAL_TOKENS:
            continue
        chars.extend(list(w))
    spans = []  # (start, end) char spans, one per doc word
    start = 0
    for w in doc_words:
        if start >= len(chars):
            break
        end = start + len(w)
        spans.append((start, end))
        start = end
    return chars, spans


def scores_per_word_from_scores_per_token(doc_words: Sequence[str],
                                          wordpieces: Sequence[str],
                                          scores_per_token) -> np.ndarray:
    """Max-pool wordpiece scores onto whitespace words via character spans
    (reference ``bert_pipeline.py:96-138``). ``wordpieces`` are the decoded
    tokens of the encoded input (incl. specials); special tokens carry no
    characters and drop out."""
    scores_per_token = np.asarray(scores_per_token, np.float64)
    pieces = [w.replace("##", "") for w in wordpieces]
    score_per_char: List[float] = []
    for i, w in enumerate(pieces[:len(scores_per_token)]):
        if w in SPECIAL_TOKENS:
            continue
        score_per_char.extend([float(scores_per_token[i])] * len(w))
    chars, spans = _chars_and_words(doc_words, wordpieces)
    out = []
    for (start, end) in spans:
        if start >= len(score_per_char):
            break
        out.append(max(score_per_char[start:end]))
    # sanity: the realigned words must reproduce the document words
    realigned = ["".join(chars[s:e]) for (s, e) in spans[:len(out)]]
    if realigned[:-1] != list(doc_words[:len(realigned) - 1]):
        raise AssertionError(
            f"wordpiece/word realignment diverged: {realigned[:5]} vs "
            f"{list(doc_words[:5])}")
    return np.asarray(out)


def get_input_words(doc_words: Sequence[str],
                    wordpieces: Sequence[str]) -> List[str]:
    """The words actually covered by the (possibly truncated) encoding
    (reference ``bert_pipeline.py:140-166``)."""
    chars, spans = _chars_and_words(doc_words, wordpieces)
    out = []
    for (start, end) in spans:
        if start >= len(chars):
            break
        out.append("".join(chars[start:end]))
    if out[:-1] != list(doc_words[:len(out) - 1]):
        raise AssertionError("wordpiece/word realignment diverged")
    return out
