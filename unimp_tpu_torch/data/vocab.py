"""Task-vocabulary extension: the port's copy of ``unimp_tpu/data/vocab.py``
(the reference's mmrec.py:537-595).

Adds, in the reference's order:
  * ``<answer>`` special token (mmrec.py:537-543)
  * per-subset atomic item tokens ``item_{i}``: all=22738, beauty=4167,
    netflix=1870, hm=14901 (mmrec.py:551-562) — or semantic-ID tokens
    (512 ``item_{i}`` + 32 ``item_last_{i}``, mmrec.py:563-571)
  * rating tokens ``rate_1..rate_5`` (mmrec.py:572-573)
  * selection tokens ``s_0..s_4`` (mmrec.py:574-575)
  * VQGAN image tokens ``img_{i},`` i<1024 (mmrec.py:578-581)
  * transfer-domain tokens ``item_domain_{i}`` (mmrec_prefix.py: office
    =1574, tool=6885)

Returns the number of tokens added so the embedding table can be resized
(reference: `model.lang_encoder.resize_token_embeddings`, mmrec.py:595).
"""

from __future__ import annotations

from typing import Optional

from unimp_tpu_torch.data.tokenizer import ANSWER_TOKEN, UniMPTokenizer

SPECIAL_TOKENS = {
    "media": "<image>",
    "endofchunk": "<|endofchunk|>",
    "answer": ANSWER_TOKEN,
}

# mmrec.py:551-562
ITEM_COUNTS = {
    "all": 22738,
    "beauty": 4167,
    "netflix": 1870,
    "hm": 14901,
}

# mmrec_prefix.py new-domain token counts
DOMAIN_ITEM_COUNTS = {
    "office": 1574,
    "tool": 6885,
}

N_SEMANTIC = 512  # mmrec.py:563-567
N_SEMANTIC_LAST = 32  # mmrec.py:568-571
N_RATES = 5
N_SELECT = 5
N_IMG_TOKENS = 1024  # mmrec.py:578-581


def extend_vocabulary(
    tokenizer: UniMPTokenizer,
    subset: str = "all",
    use_semantic: bool = False,
    task: Optional[str] = None,
    n_items: Optional[int] = None,
    transfer_domain: Optional[str] = None,
) -> int:
    """Extend `tokenizer` with the task vocabulary; returns tokens added."""
    n = tokenizer.add_tokens([ANSWER_TOKEN], special=True)

    if not use_semantic:
        if n_items is None:
            n_items = ITEM_COUNTS.get(subset)
            if n_items is None:
                raise KeyError(f"unknown subset {subset!r}; pass n_items")
        n += tokenizer.add_tokens([f"item_{i}" for i in range(n_items)])
    else:
        n += tokenizer.add_tokens([f"item_{i}" for i in range(N_SEMANTIC)])
        n += tokenizer.add_tokens([f"item_last_{i}" for i in range(N_SEMANTIC_LAST)])

    n += tokenizer.add_tokens([f"rate_{i}" for i in range(1, N_RATES + 1)])
    n += tokenizer.add_tokens([f"s_{i}" for i in range(N_SELECT)])

    if task in (None, "img_gen", "all") or task == "img_gen":
        n += tokenizer.add_tokens([f"img_{i}," for i in range(N_IMG_TOKENS)])

    if transfer_domain is not None:
        count = DOMAIN_ITEM_COUNTS.get(transfer_domain)
        if count is None:
            raise KeyError(f"unknown transfer domain {transfer_domain!r}")
        n += tokenizer.add_tokens([f"item_domain_{i}" for i in range(count)])
    return n
