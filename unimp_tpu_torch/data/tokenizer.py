"""Hermetic word-level tokenizer, in pure Python.

Counterpart of ``unimp_tpu/data/tokenizer.py``, which wraps the Rust
``tokenizers`` library: a ``WordLevel`` model over a corpus vocabulary,
pre-tokenized by ``Whitespace`` then ``Punctuation``, with thousands of
added task tokens (``item_{i}``, ``img_{i},``, ``<answer>`` ...) matched
atomically. This module gives the same ids for the same text, token for
token, and reads and writes the same ``tokenizer.json``:

  * added tokens are found in the raw text first, leftmost-longest, as
    substrings (``"item_3item_17"`` is two tokens, ``"xitem_12y"`` splits
    around ``item_12``, ``"img_789,"`` keeps its comma);
  * the pieces between them split into runs of word characters and runs
    of other characters (``\\w+|[^\\w\\s]+``, whitespace dropped), then
    every punctuation character stands alone (``"a_b"`` -> ``a _ b``);
  * each piece is looked up in the vocabulary (no normalizer: a word the
    vocabulary lacks, upper case included, is ``<unk>``).

The character classes are the library's, not Python's ``re``: its
``\\w`` follows a newer Unicode than Python 3.12's ``unicodedata`` (15.0)
and adds Join_Control and the Other_Alphabetic symbols (circled and
squared letters), and its punctuation table is an older one. The
``_EXTRA_*`` ranges below hold every code point where the rule from
``unicodedata`` and the library differ, found by running both over all
of Unicode.

``from_hf`` (a BPE ``tokenizer.json``) is not ported.
"""

from __future__ import annotations

import functools
import json
import re
import string
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

PAD, UNK, BOS, EOS = "<pad>", "<unk>", "<s>", "</s>"
MEDIA_TOKEN = "<image>"
ENDOFCHUNK_TOKEN = "<|endofchunk|>"
ANSWER_TOKEN = "<answer>"

# from_corpus's own word split (Python's re, as in the JAX package)
_WORD_RE = re.compile(r"\w+|[^\w\s]")

_SPACE, _WORD, _OTHER, _PUNCT = range(4)
# Unicode White_Space
_WHITESPACE = frozenset(chr(c) for c in (
    0x9, 0xA, 0xB, 0xC, 0xD, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000))
_WORD_CATEGORIES = frozenset(("Lu", "Ll", "Lt", "Lm", "Lo", "Nl", "Mn", "Mc", "Me", "Nd", "Pc"))
# word characters to the library that unicodedata calls unassigned, a
# symbol or a format character
_EXTRA_WORD = (
    (0x897, 0x897), (0x1C89, 0x1C8A), (0x200C, 0x200D), (0x24B6, 0x24E9), (0xA7CB, 0xA7CD),
    (0xA7DA, 0xA7DC), (0x105C0, 0x105F3), (0x10D40, 0x10D65), (0x10D69, 0x10D6D),
    (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x10EFC, 0x10EFC), (0x11380, 0x11389),
    (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113C0),
    (0x113C2, 0x113C2), (0x113C5, 0x113C5), (0x113C7, 0x113CA), (0x113CC, 0x113D3),
    (0x113E1, 0x113E2), (0x116D0, 0x116E3), (0x11BC0, 0x11BE0), (0x11BF0, 0x11BF9),
    (0x11F5A, 0x11F5A), (0x13460, 0x143FA), (0x16100, 0x16139), (0x16D40, 0x16D6C),
    (0x16D70, 0x16D79), (0x18CFF, 0x18CFF), (0x1CCF0, 0x1CCF9), (0x1E5D0, 0x1E5FA),
    (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189), (0x2EBF0, 0x2EE5D),
)
# punctuation to unicodedata that the library's older table does not know
_EXTRA_OTHER = (
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77), (0xC84, 0xC84),
    (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D), (0x10EAD, 0x10EAD),
    (0x10F55, 0x10F59), (0x10F86, 0x10F89), (0x1144B, 0x1144F), (0x1145A, 0x1145B),
    (0x1145D, 0x1145D), (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B),
    (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46), (0x11A9A, 0x11A9C),
    (0x11A9E, 0x11AA2), (0x11B00, 0x11B09), (0x11C41, 0x11C45), (0x11C70, 0x11C71),
    (0x11EF7, 0x11EF8), (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F),
)
# punctuation in the library's table that unicodedata has moved elsewhere
_EXTRA_PUNCT = ((0x166D, 0x166D), (0x111C9, 0x111C9))


def _in(ranges, c: int) -> bool:
    return any(lo <= c <= hi for lo, hi in ranges)


@functools.lru_cache(maxsize=1 << 16)
def _char_class(ch: str) -> int:
    if ch in _WHITESPACE:
        return _SPACE
    c = ord(ch)
    if _in(_EXTRA_PUNCT, c):
        return _PUNCT
    if _in(_EXTRA_OTHER, c):
        return _OTHER
    cat = unicodedata.category(ch)
    if ch in string.punctuation or cat[0] == "P":
        return _PUNCT
    if cat in _WORD_CATEGORIES or _in(_EXTRA_WORD, c):
        return _WORD
    return _OTHER


def pre_tokenize(text: str) -> List[str]:
    """``Whitespace`` then ``Punctuation``: runs of word or of other
    characters, whitespace dropped, each punctuation character alone."""
    out: List[str] = []
    start, kind = 0, _SPACE
    for i, ch in enumerate(text):
        c = _char_class(ch)
        if c == kind and c in (_WORD, _OTHER):
            continue
        if kind in (_WORD, _OTHER):
            out.append(text[start:i])
        if c == _PUNCT:
            out.append(ch)
        start, kind = i, c
    if kind in (_WORD, _OTHER):
        out.append(text[start:])
    return out


class UniMPTokenizer:
    """HF-compatible-surface tokenizer (encode/decode/add_tokens/len)."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK):
        if unk_token not in vocab:
            raise KeyError(f"unk token {unk_token!r} not in the vocabulary")
        self._vocab = dict(vocab)
        self._vocab_r = {i: t for t, i in self._vocab.items()}
        self._unk_id = self._vocab[unk_token]
        self._unk_token = unk_token
        self._added: Dict[str, int] = {}  # content -> id
        self._added_r: Dict[int, tuple] = {}  # id -> (content, special)
        self._lengths: Dict[str, List[int]] = {}  # first char -> lengths, longest first
        self._special = {PAD, UNK, BOS, EOS, MEDIA_TOKEN, ENDOFCHUNK_TOKEN}

    # ---------------- construction ----------------

    @classmethod
    def from_corpus(cls, texts: Iterable[str], min_freq: int = 1,
                    max_vocab: Optional[int] = None) -> "UniMPTokenizer":
        counter: Counter = Counter()
        for t in texts:
            counter.update(w.lower() for w in _WORD_RE.findall(t))
        words = [w for w, c in counter.most_common(max_vocab) if c >= min_freq]
        vocab = {PAD: 0, UNK: 1, BOS: 2, EOS: 3}
        for w in words:
            vocab[w] = len(vocab)
        return cls.from_vocab(vocab)

    @classmethod
    def from_vocab(cls, vocab: dict) -> "UniMPTokenizer":
        obj = cls(vocab)
        obj._add_core_specials()
        return obj

    @classmethod
    def from_hf(cls, tokenizer_json_path: str) -> "UniMPTokenizer":
        raise NotImplementedError(
            "a pretrained BPE tokenizer.json is not ported yet (ROADMAP.md §1, item 8a)")

    def _add_core_specials(self):
        self._add([MEDIA_TOKEN, ENDOFCHUNK_TOKEN], special=True)

    # ---------------- persistence ----------------

    def save(self, path: str):
        """A ``tokenizer.json`` that the ``tokenizers`` library reads."""
        added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
                  "rstrip": False, "normalized": False, "special": special}
                 for i, (t, special) in sorted(self._added_r.items())]
        obj = {
            "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Whitespace"}, {"type": "Punctuation", "behavior": "Isolated"}]},
            "post_processor": None, "decoder": None,
            "model": {"type": "WordLevel", "vocab": self._vocab, "unk_token": self._unk_token},
        }
        with open(path, "w") as f:
            json.dump(obj, f, ensure_ascii=False, indent=2)

    @classmethod
    def load(cls, path: str) -> "UniMPTokenizer":
        """Read a ``tokenizer.json`` of the JAX package's ``save`` (a
        WordLevel model). Decoding then skips the six default specials
        only, as the JAX ``load`` does."""
        with open(path) as f:
            obj = json.load(f)
        model = obj.get("model", {})
        if model.get("type") != "WordLevel":
            raise NotImplementedError(
                f"{model.get('type')} tokenizer.json: only WordLevel is ported "
                "(ROADMAP.md §1, item 8a)")
        pre = obj.get("pre_tokenizer") or {}
        kinds = [p.get("type") for p in pre.get("pretokenizers", [])]
        if obj.get("normalizer") is not None or kinds != ["Whitespace", "Punctuation"] \
                or pre["pretokenizers"][1].get("behavior", "Isolated") != "Isolated":
            raise NotImplementedError("only the Whitespace + Punctuation pre-tokenizer "
                                      "without a normalizer is ported")
        tok = cls(model["vocab"], model.get("unk_token", UNK))
        for t in obj.get("added_tokens", []):
            if t["normalized"] or t["single_word"] or t["lstrip"] or t["rstrip"]:
                raise NotImplementedError(f"added token options of {t['content']!r}")
            tok._put(t["content"], int(t["id"]), bool(t["special"]))
        return tok

    # ---------------- added vocabulary ----------------

    def _put(self, content: str, tid: int, special: bool):
        old = self._added.get(content)
        if old is not None and old != tid:
            del self._added_r[old]
        self._added[content] = tid
        self._added_r[tid] = (content, special)
        lens = self._lengths.setdefault(content[0], [])
        if len(content) not in lens:
            lens.append(len(content))
            lens.sort(reverse=True)

    def _add(self, tokens: Sequence[str], special: bool) -> int:
        """The library's AddedVocabulary.add_tokens: a token equal to one
        already added (content and flags) is skipped; one known keeps its
        id; a new one takes the next id after the model's and the added
        ones. Returns how many were taken."""
        n = 0
        seen = set(self._added_r.values())
        for t in tokens:
            if not t or (t, special) in seen:
                continue
            tid = self._added.get(t, self._vocab.get(t))
            if tid is None:
                size = len(self._vocab)
                top = max(self._added.values(), default=None)
                tid = size if top is None or (top < size and size > 0) else top + 1
            self._put(t, tid, special)
            seen.add((t, special))
            n += 1
        return n

    def add_tokens(self, tokens: Sequence[str], special: bool = False) -> int:
        if special:
            self._special.update(tokens)
        return self._add(tokens, special)

    def add_special_tokens(self, mapping: dict) -> int:
        """HF-style: {"additional_special_tokens": [...]} etc."""
        n = 0
        for value in mapping.values():
            if isinstance(value, str):
                value = [value]
            n += self.add_tokens(value, special=True)
            self._special.update(value)
        return n

    # ---------------- encode / decode ----------------

    def _split_added(self, text: str):
        """Yield (piece, added id or None): leftmost-longest added tokens."""
        start = i = 0
        n = len(text)
        while i < n:
            for ln in self._lengths.get(text[i], ()):
                tid = self._added.get(text[i:i + ln])
                if tid is not None:
                    if start < i:
                        yield text[start:i], None
                    yield None, tid
                    i += ln
                    start = i
                    break
            else:
                i += 1
        if start < n:
            yield text[start:], None

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids: List[int] = []
        for piece, tid in self._split_added(text):
            if tid is not None:
                ids.append(tid)
            else:
                ids.extend(self._vocab.get(w, self._unk_id) for w in pre_tokenize(piece))
        if add_bos:
            ids = [self.bos_token_id] + ids
        if add_eos:
            ids = ids + [self.eos_token_id]
        return ids

    def id_to_token(self, tid: int) -> Optional[str]:
        added = self._added_r.get(tid)
        return added[0] if added is not None else self._vocab_r.get(tid)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            t = self.id_to_token(int(i))
            if t is None:
                continue
            if skip_special_tokens and t in self._special:
                continue
            toks.append(t)
        return " ".join(toks)

    def batch_decode(self, batch, skip_special_tokens: bool = True):
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._added.get(token)
        return tid if tid is not None else self._vocab.get(token)

    def convert_tokens_to_ids(self, token: str) -> int:
        tid = self.token_to_id(token)
        if tid is None:
            raise KeyError(f"token {token!r} not in vocabulary")
        return tid

    def __len__(self) -> int:
        return len(self._vocab.keys() | self._added.keys())

    @property
    def vocab_size(self) -> int:
        return len(self)

    @property
    def pad_token_id(self) -> int:
        return self.token_to_id(PAD)

    @property
    def unk_token_id(self) -> int:
        return self.token_to_id(UNK)

    @property
    def bos_token_id(self) -> int:
        return self.token_to_id(BOS)

    @property
    def eos_token_id(self) -> int:
        return self.token_to_id(EOS)

    @property
    def media_token_id(self) -> int:
        return self.token_to_id(MEDIA_TOKEN)

    @property
    def endofchunk_token_id(self) -> int:
        return self.token_to_id(ENDOFCHUNK_TOKEN)

    @property
    def answer_token_id(self) -> int:
        tid = self.token_to_id(ANSWER_TOKEN)
        if tid is None:
            raise KeyError("<answer> not added yet; call extend_vocabulary")
        return tid
