"""Constants for SemEval-2010 Task 8 (a copy of
``gcn_tpu.constants_semeval``).

These tables reproduce the reference's (reference
``utils/constant_semeval.py``).  Unlike the TACRED table, the SemEval deprel
table has **no** reverse band and no self-loop id (reference
``utils/constant_semeval.py:24``) — but the graph pipeline still uses the
banded scheme at adjacency-build time (forward +42 / self-loop 84), as the
reference's ``model/tree.py`` applies the TACRED band offsets whatever the
dataset.
"""

from __future__ import annotations

import gcn_tpu_torch.constants as _tacred
# re-exported: the tables SemEval shares with TACRED
from gcn_tpu_torch.constants import (  # noqa: F401
    _DEPREL_NAMES,
    EMB_INIT_RANGE,
    INFINITY_NUMBER,
    NER_TO_ID,
    OBJ_NER_TO_ID,
    PAD_ID,
    PAD_TOKEN,
    SUBJ_NER_TO_ID,
    UNK_ID,
    UNK_TOKEN,
    VOCAB_PREFIX,
)

# SemEval POS table adds one extra 'pad' tag at id 47
# (constant_semeval.py:22).
POS_TO_ID = dict(_tacred.POS_TO_ID)
POS_TO_ID["pad"] = 47

# Forward-only deprel table (constant_semeval.py:24).
DEPREL_TO_ID = {PAD_TOKEN: 0, UNK_TOKEN: 1}
for _i, _name in enumerate(_DEPREL_NAMES):
    DEPREL_TO_ID[_name] = 2 + _i

NEGATIVE_LABEL = "Other"

LABEL_TO_ID = {
    "Other": 0, "Entity-Destination": 1, "Cause-Effect": 2,
    "Member-Collection": 3, "Entity-Origin": 4, "Message-Topic": 5,
    "Component-Whole": 6, "Instrument-Agency": 7, "Product-Producer": 8,
    "Content-Container": 9,
}

ID_TO_LABEL = {v: k for k, v in LABEL_TO_ID.items()}

NUM_DEPREL = len(DEPREL_TO_ID)  # 42 (forward only)
NUM_POS = len(POS_TO_ID)        # 48
NUM_CLASS = len(LABEL_TO_ID)    # 10
