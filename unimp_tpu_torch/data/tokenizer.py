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

A pretrained byte-level BPE ``tokenizer.json`` (GPT-2's scheme, which
GPT-NeoX and MPT use) is read by ``from_hf`` and ``load`` too, and encodes
as the library does: added tokens are matched in the raw text (those
flagged ``normalized`` after the normalizer, in the pieces between the
others), with their ``lstrip`` / ``rstrip`` / ``single_word`` flags; the
pieces between them take the ``NFC`` normalizer (or none), the
``ByteLevel`` pre-tokenizer (a space put in front of every piece under
``add_prefix_space``; GPT-2's split regex, its ``\\p{L}`` / ``\\p{N}`` by
``unicodedata`` plus the ``_EXTRA_LETTER`` / ``_EXTRA_NUMBER`` code points
of the library's newer Unicode; each UTF-8 byte as its printable
character) and the BPE merges, lowest rank first, leftmost first among
equals. The ``ByteLevel`` decoder joins the tokens' bytes (a token with a
character outside the byte alphabet, a space for one, as its own UTF-8) and replaces invalid UTF-8 as the library does.
Other models, normalizers, pre-tokenizers and decoders raise, naming
themselves, as do BPE dropout, ``byte_fallback``, ``fuse_unk`` and
subword affixes.
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

_SPACE, _WORD, _OTHER, _PUNCT, _LETTER, _NUMBER = range(6)
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


# letters and numbers to the library's byte-level split regex (\p{L}, \p{N})
# that Python 3.12's unicodedata (Unicode 15.0) leaves unassigned: found by
# running both over every code point
_EXTRA_LETTER = (
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
    (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
    (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
    (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D),
)
_EXTRA_NUMBER = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
    (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA),
)
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@functools.lru_cache(maxsize=1 << 16)
def _byte_level_class(ch: str) -> int:
    if ch in _WHITESPACE:
        return _SPACE
    cat, c = unicodedata.category(ch), ord(ch)
    if cat[0] == "L" or _in(_EXTRA_LETTER, c):
        return _LETTER
    if cat[0] == "N" or _in(_EXTRA_NUMBER, c):
        return _NUMBER
    return _OTHER


def _bytes_to_chars() -> Dict[int, str]:
    """GPT-2's byte alphabet: printable Latin-1 bytes stand for themselves,
    the others for the code points from 256 up, in byte order."""
    keep = [*range(0x21, 0x7F), *range(0xA1, 0xAD), *range(0xAE, 0x100)]
    rest = [b for b in range(256) if b not in keep]
    return {**{b: chr(b) for b in keep}, **{b: chr(256 + k) for k, b in enumerate(rest)}}


BYTE_CHAR = _bytes_to_chars()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


def byte_level_split(text: str) -> List[str]:
    r"""GPT-2's split, ``'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|
    ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+``, as the library's regex matches it."""
    out: List[str] = []
    cls = [_byte_level_class(ch) for ch in text]
    i, n = 0, len(text)
    while i < n:
        if text[i] == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i + 1)), None)
            if c is not None:
                out.append(text[i:i + 1 + len(c)])
                i += 1 + len(c)
                continue
        j = i + 1 if text[i] == " " and i + 1 < n and cls[i + 1] != _SPACE else i
        kind, e = cls[j], j + 1
        while e < n and cls[e] == kind:
            e += 1
        if kind == _SPACE and e < n and e - i > 1:
            e -= 1  # the run's last space goes with what follows it
        out.append(text[i:e])
        i = e
    return out


class _BPE:
    """A byte-level BPE model of a ``tokenizer.json``."""

    def __init__(self, obj: dict):
        model = obj["model"]
        for opt in ("dropout", "byte_fallback", "fuse_unk", "continuing_subword_prefix",
                    "end_of_word_suffix"):
            if model.get(opt):
                raise NotImplementedError(f"BPE {opt}={model.get(opt)!r} is not ported")
        norm = obj.get("normalizer")
        if norm is not None and norm.get("type") != "NFC":
            raise NotImplementedError(f"normalizer {norm.get('type')!r}: only NFC is ported")
        pre = obj.get("pre_tokenizer") or {}
        if pre.get("type") != "ByteLevel":
            raise NotImplementedError(f"pre-tokenizer {pre.get('type')!r}: only ByteLevel is "
                                      "ported for BPE")
        dec = obj.get("decoder")
        if dec is not None and dec.get("type") != "ByteLevel":
            raise NotImplementedError(f"decoder {dec.get('type')!r}: only ByteLevel is ported")
        self.source = obj  # written back by ``save`` with the added tokens
        self.nfc = norm is not None
        self.add_prefix_space = bool(pre.get("add_prefix_space", True))
        self.use_regex = bool(pre.get("use_regex", True))
        self.byte_decoder = dec is not None
        self.unk = model.get("unk_token")
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.vocab = model["vocab"]
        self.ranks = {}
        for rank, m in enumerate(model.get("merges", [])):
            a, b = m.split(" ") if isinstance(m, str) else m
            if a + b not in self.vocab:
                raise ValueError(f"merge {a!r} {b!r}: {a + b!r} is not in the vocabulary")
            self.ranks.setdefault((a, b), rank)
        self.cache: Dict[str, List[int]] = {}

    def word(self, w: str) -> List[int]:
        """One pre-token (byte characters) -> ids."""
        got = self.cache.get(w)
        if got is not None:
            return got
        if self.ignore_merges and w in self.vocab:
            got = [self.vocab[w]]
        else:
            syms: List[Optional[str]] = []  # None: the unknown token
            for ch in w:
                if ch in self.vocab:
                    syms.append(ch)
                elif self.unk is not None:  # without one the library drops the character
                    syms.append(None)
            while len(syms) > 1:
                best = min(((self.ranks.get((a, b)), k) for k, (a, b) in
                            enumerate(zip(syms, syms[1:])) if (a, b) in self.ranks), default=None)
                if best is None:
                    break
                k = best[1]
                syms[k:k + 2] = [syms[k] + syms[k + 1]]
            got = [self.vocab[s] if s is not None else self.vocab[self.unk] for s in syms]
        self.cache[w] = got
        return got

    def encode(self, piece: str) -> List[int]:
        """A piece between added tokens (normalized) -> ids."""
        if self.add_prefix_space and not piece.startswith(" "):
            piece = " " + piece
        ids: List[int] = []
        for w in byte_level_split(piece) if self.use_regex else [piece]:
            ids.extend(self.word("".join(BYTE_CHAR[b] for b in w.encode("utf-8"))))
        return ids

    def decode(self, tokens: List[str]) -> str:
        if not self.byte_decoder:
            return " ".join(tokens)
        buf = bytearray()
        for t in tokens:
            if all(c in CHAR_BYTE for c in t):
                buf += bytes(CHAR_BYTE[c] for c in t)
            else:
                buf += t.encode("utf-8")
        return buf.decode("utf-8", errors="replace")


def _is_word_char(ch: str) -> bool:
    """The regex crate's word characters, which ``single_word`` looks for."""
    return unicodedata.category(ch) in _WORD_CATEGORIES or _in(_EXTRA_WORD, ord(ch))


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

    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK, bpe: "_BPE" = None):
        if bpe is None and unk_token not in vocab:
            raise KeyError(f"unk token {unk_token!r} not in the vocabulary")
        self._vocab = dict(vocab)
        self._vocab_r = {i: t for t, i in self._vocab.items()}
        self._unk_id = self._vocab.get(unk_token)
        self._unk_token = unk_token
        self._bpe = bpe  # None: the WordLevel model
        self._added: Dict[str, int] = {}  # content -> id
        self._added_r: Dict[int, tuple] = {}  # id -> (content, special)
        self._flags: Dict[str, tuple] = {}  # content -> (normalized, lstrip, rstrip, single_word)
        self._nadded: Dict[str, int] = {}  # normalized tokens: normalized content -> id
        # first char -> lengths, longest first: raw-text tokens, normalized ones
        self._lengths: Dict[str, List[int]] = {}
        self._nlengths: Dict[str, List[int]] = {}
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
        """A pretrained ``tokenizer.json`` (byte-level BPE, or WordLevel),
        with the PAD / UNK / BOS / EOS it lacks added as special tokens
        (never aliased), then the media and end-of-chunk tokens, as the
        JAX ``from_hf`` does."""
        tok = cls.load(tokenizer_json_path)
        tok._add([t for t in (PAD, UNK, BOS, EOS) if tok.token_to_id(t) is None], special=True)
        tok._add_core_specials()
        return tok

    def _add_core_specials(self):
        self._add([MEDIA_TOKEN, ENDOFCHUNK_TOKEN], special=True)

    # ---------------- persistence ----------------

    def save(self, path: str):
        """A ``tokenizer.json`` that the ``tokenizers`` library reads."""
        added = []
        for i, (t, special) in sorted(self._added_r.items()):
            normalized, lstrip, rstrip, single = self._flags[t]
            added.append({"id": i, "content": t, "single_word": single, "lstrip": lstrip,
                          "rstrip": rstrip, "normalized": normalized, "special": special})
        if self._bpe is not None:
            with open(path, "w", encoding="utf-8") as f:
                json.dump({**self._bpe.source, "added_tokens": added}, f, ensure_ascii=False)
            return
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
        """Read a ``tokenizer.json``: the JAX package's ``save`` (a
        WordLevel model; decoding then skips the six default specials only,
        as the JAX ``load`` does) or a byte-level BPE one."""
        with open(path, encoding="utf-8") as f:
            obj = json.load(f)
        model = obj.get("model", {})
        if model.get("type") == "BPE":
            bpe = _BPE(obj)
            tok = cls(model["vocab"], model.get("unk_token"), bpe=bpe)
            for t in obj.get("added_tokens", []):
                tok._put(t["content"], int(t["id"]), bool(t["special"]),
                         *(bool(t.get(k, False)) for k in ("normalized", "lstrip", "rstrip",
                                                             "single_word")))
            return tok
        if model.get("type") != "WordLevel":
            raise NotImplementedError(
                f"{model.get('type')} tokenizer.json: only WordLevel and byte-level BPE are "
                "ported")
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

    def _put(self, content: str, tid: int, special: bool, normalized: bool = False,
             lstrip: bool = False, rstrip: bool = False, single_word: bool = False):
        old = self._added.get(content)
        if old is not None and old != tid:
            del self._added_r[old]
        self._added[content] = tid
        self._added_r[tid] = (content, special)
        self._flags[content] = (normalized, lstrip, rstrip, single_word)
        key = self._match_key(content) if normalized else content
        if normalized:
            self._nadded[key] = tid
        lens = (self._nlengths if normalized else self._lengths).setdefault(key[0], [])
        if len(key) not in lens:
            lens.append(len(key))
            lens.sort(reverse=True)

    def _match_key(self, content: str) -> str:
        """What a normalized added token matches: its content normalized."""
        if self._bpe is not None and self._bpe.nfc:
            return unicodedata.normalize("NFC", content)
        return content

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

    def _split_added(self, text: str, normalized: bool = False):
        """Yield (piece, added id or None): leftmost-longest added tokens
        (the raw-text ones, or the normalized ones), widened over the
        whitespace beside them under ``lstrip`` / ``rstrip`` and skipped
        where ``single_word`` finds a word character beside them, as the
        library's ``find_matches`` does."""
        lengths, table = ((self._nlengths, self._nadded) if normalized
                          else (self._lengths, self._added))
        start = i = 0
        n = len(text)
        while i < n:
            for ln in lengths.get(text[i], ()):
                tid = table.get(text[i:i + ln])
                if tid is None or self._flags[self._added_r[tid][0]][0] != normalized:
                    continue
                _, lstrip, rstrip, single = self._flags[self._added_r[tid][0]]
                lo, hi = i, i + ln
                if single and ((lo > 0 and _is_word_char(text[lo - 1]))
                               or (hi < n and _is_word_char(text[hi]))):
                    i = hi  # discarded; the search goes on after it
                    break
                if lstrip:
                    while lo > start and text[lo - 1] in _WHITESPACE:
                        lo -= 1
                if rstrip:
                    while hi < n and text[hi] in _WHITESPACE:
                        hi += 1
                if start < lo:
                    yield text[start:lo], None
                yield None, tid
                i = start = hi
                break
            else:
                i += 1
        if start < n:
            yield text[start:], None

    def _encode_bpe(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece, tid in self._split_added(text):
            if tid is not None:
                ids.append(tid)
                continue
            if self._bpe.nfc:
                piece = unicodedata.normalize("NFC", piece)
            for sub, ntid in self._split_added(piece, normalized=True):
                ids.extend([ntid] if ntid is not None else self._bpe.encode(sub))
        return ids

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        if self._bpe is not None:
            ids = self._encode_bpe(text)
        else:
            ids = []
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
        """WordLevel: the tokens joined by spaces, the default specials
        skipped. BPE: the library's decode, skipping the added tokens
        flagged special, through the model's decoder."""
        special = self._special
        if self._bpe is not None:
            special = {t for t, is_special in self._added_r.values() if is_special}
        toks = []
        for i in ids:
            t = self.id_to_token(int(i))
            if t is None:
                continue
            if skip_special_tokens and t in special:
                continue
            toks.append(t)
        return self._bpe.decode(toks) if self._bpe is not None else " ".join(toks)

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
