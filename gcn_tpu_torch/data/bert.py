"""Token preprocessing of the precomputed contextual-embedding inputs
("BERT path"): a copy of the JAX-free part of ``gcn_tpu.data.bert``.

The inputs themselves are a dict from example id to an ``[L, D]`` float
array, one vector per original token (``RelationDataset``'s
``bert_embeddings``).  Before encoding, tokens take the reference's PTB
bracket normalization (``data/bert_embeddings.py:18-27``) and SUBJ-/OBJ-
entity anonymization (``:30-45``).  The encoding step itself
(``gcn_tpu.data.bert.extract_embeddings``, which runs a BERT checkpoint
through ``transformers``) is not ported.
"""

from __future__ import annotations

# PTB bracket tokens → literal brackets (reference
# data/bert_embeddings.py:18-27)
BRACKET_MAP = {
    "-LRB-": "(", "-RRB-": ")",
    "-LSB-": "[", "-RSB-": "]",
    "-LCB-": "{", "-RCB-": "}",
}


def normalize_tokens(tokens: list[str]) -> list[str]:
    return [BRACKET_MAP.get(t, t) for t in tokens]


def anonymize(example: dict) -> list[str]:
    """SUBJ-/OBJ- entity masking (reference data/bert_embeddings.py:30-45)."""
    tokens = list(example["token"])
    ss, se = example["subj_start"], example["subj_end"]
    os_, oe = example["obj_start"], example["obj_end"]
    tokens[ss : se + 1] = ["SUBJ-" + example["subj_type"]] * (se - ss + 1)
    tokens[os_ : oe + 1] = ["OBJ-" + example["obj_type"]] * (oe - os_ + 1)
    return normalize_tokens(tokens)
