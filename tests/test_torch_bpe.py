"""The port's byte-level BPE ``tokenizer.json`` reader against the
``tokenizers`` library, on the CPU.

Files are trained here by the library on a small mixed corpus: with
``add_prefix_space`` off under the ``NFC`` normalizer and merges written
as ``"a b"`` strings, with it on without a normalizer and merges as
``["a", "b"]`` pairs (as the library writes them), with only the
corpus's bytes (the others ``<unk>``) and ``ignore_merges``, and a GPT-NeoX-like
file (``<|endoftext|>`` special; runs of spaces as ``normalized`` added
tokens; added tokens with ``lstrip`` / ``rstrip`` / ``single_word``).
``from_hf`` and ``load`` are held to the JAX package's (the library
itself) id for id on ASCII, accented, decomposed, CJK and emoji text,
runs of spaces and newlines, digits, contractions, the code points the
library's Unicode classes differently from ``unicodedata``, and task
tokens glued to words; ``decode`` both ways on the same ids and on
random ids (cut UTF-8 sequences included), string for string; the task
tokens stay atomic (``tests/test_data.py``'s BPE case); the port's
``save`` reads back in the library.
"""

import json

import numpy as np
import pytest
from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers, pre_tokenizers
from tokenizers.trainers import BpeTrainer

from unimp_tpu.data.tokenizer import UniMPTokenizer as JTokenizer
from unimp_tpu.data.vocab import extend_vocabulary as j_extend
from unimp_tpu_torch.data import tokenizer as tokmod
from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
from unimp_tpu_torch.data.vocab import extend_vocabulary

CORPUS = [
    "the user bought a bright red lipstick and a soft face cream",
    "what item does the user prefer next? history of purchases",
    "Café crème brûlée, naïve façade: déjà vu über alles",
    "他们购买了口红和面霜 東京の店で買いました",
    "emoji 🙂🙃 and 👍🏽 with digits 12345 67890 3.14159",
    "don't can't I'm you're we've they'll she'd it's",
    "tabs\tand\nnewlines\n\n  and   runs    of spaces",
] * 6

TEXTS = [
    "the user bought a bright red lipstick",
    "  leading and trailing spaces   ",
    "Café crème brûlée déjà vu",
    "Café crème: decomposed accents",  # NFC composes these
    "他们购买了口红 東京",
    "emoji 🙂🙃👍🏽 and 🧪 unseen",
    "digits 1234567890 and 3.14159 2024-01-02",
    "don't can't I'm you're we've they'll she'd 'S 'LL",
    "tabs\tand\nnewlines\n\n\nend\r\n",
    "a  b   c    d",
    "item_3item_17item_last_9 img_789,img_591,",
    "the user bought item_12 and rated it rate_5",
    "what does the user prefer next?item_7",
    "xitem_12y <image>hello<|endofchunk|> world",
    "\u001c\u001d\u001e\u001f separators \u0085   spaces",
    "new letters \U00011390\U00011391 \U0001e5d0 numbers \U00016130\U00016131",
    "",
    " ",
    "<|endoftext|>next <|endoftext|> tail",
    "  lspace<L> <R>  rspace <W>word <W> alone x<W>y",
]


def _train(add_prefix_space, nfc, unk=False):
    """Every byte in the vocabulary; or, with ``unk``, only the corpus's
    bytes, the rest ``<unk>``, and ``ignore_merges`` on."""
    tk = Tokenizer(models.BPE(unk_token="<unk>", ignore_merges=True) if unk else models.BPE())
    tk.normalizer = normalizers.NFC() if nfc else None
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=add_prefix_space)
    tk.decoder = decoders.ByteLevel()
    kw = (dict(special_tokens=["<unk>"]) if unk
          else dict(initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tk.train_from_iterator(CORPUS, BpeTrainer(vocab_size=700, show_progress=False, **kw))
    return tk


def _write(tmp_path, name, tk, merges_as_strings=False):
    obj = json.loads(tk.to_str())
    if merges_as_strings:
        obj["model"]["merges"] = [" ".join(m) for m in obj["model"]["merges"]]
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(obj, ensure_ascii=False))
    return str(path)


@pytest.fixture(scope="module", params=["nfc_no_prefix_strings", "prefix_pairs",
                                        "unk_ignore_merges", "neox_like"])
def path(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    if request.param == "nfc_no_prefix_strings":
        return _write(tmp, request.param, _train(False, True), merges_as_strings=True)
    if request.param == "prefix_pairs":
        return _write(tmp, request.param, _train(True, False))
    if request.param == "unk_ignore_merges":
        return _write(tmp, request.param, _train(True, False, unk=True))
    tk = _train(False, True)
    tk.add_special_tokens([AddedToken("<|endoftext|>", normalized=False)])
    tk.add_tokens([AddedToken(" " * n, normalized=True) for n in (2, 3, 4)])
    tk.add_tokens([AddedToken("<L>", lstrip=True, normalized=False),
                   AddedToken("<R>", rstrip=True, normalized=False),
                   AddedToken("<W>", single_word=True, normalized=False)])
    return _write(tmp, request.param, tk)


def _pair(path, how):
    if how == "from_hf":
        return JTokenizer.from_hf(path), UniMPTokenizer.from_hf(path)
    return JTokenizer.load(path), UniMPTokenizer.load(path)


@pytest.mark.parametrize("how", ["from_hf", "load"])
def test_encode_decode_equal_the_library(path, how, tmp_path):
    j, t = _pair(path, how)
    assert len(t) == len(j)
    for text in TEXTS + CORPUS[:7]:
        ids = t.encode(text)
        assert ids == j.encode(text), repr(text)
        for skip in (True, False):
            assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip), repr(text)
    rng = np.random.default_rng(0)
    for _ in range(200):  # random ids: byte tokens cut mid-character, specials anywhere
        ids = rng.integers(0, len(j), rng.integers(1, 12)).tolist()
        for skip in (True, False):
            assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip), ids
    saved = str(tmp_path / "saved.json")  # the port's save reads back in the library
    t.save(saved)
    lib = Tokenizer.from_file(saved)
    assert [lib.encode(x, add_special_tokens=False).ids for x in TEXTS] == [
        t.encode(x) for x in TEXTS]


@pytest.mark.parametrize("kw", [dict(subset="beauty", use_semantic=True),
                                dict(subset="beauty", task="img_gen")])
def test_task_tokens_stay_atomic_over_bpe(path, kw):
    j, t = JTokenizer.from_hf(path), UniMPTokenizer.from_hf(path)
    assert extend_vocabulary(t, **kw) == j_extend(j, **kw)
    assert len(t) == len(j)
    for text in TEXTS:
        ids = t.encode(text)
        assert ids == j.encode(text), repr(text)
        for skip in (True, False):
            assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip), repr(text)
    for tok in ("<answer>", "item_3", "item_17", "item_last_9", "img_789,", "<image>", "<pad>",
                "<unk>", "<s>", "</s>"):
        tid = t.token_to_id(tok)
        assert tid == j._tk.token_to_id(tok), tok
        if tid is not None:
            assert t.encode(tok) == [tid], tok
    if kw.get("use_semantic"):
        ids = t.encode("item_3item_17item_last_9")
        assert ids == [t.convert_tokens_to_ids(x) for x in ("item_3", "item_17", "item_last_9")]
    else:
        ids = t.encode("img_789,img_591,")
        assert ids == [t.convert_tokens_to_ids(x) for x in ("img_789,", "img_591,")]
    assert t.pad_token_id == j.pad_token_id and t.media_token_id == j.media_token_id


def test_byte_level_split_and_alphabet():
    """The split on its own against the library's ByteLevel pre-tokenizer
    (every code point of the extra tables, and the separators that
    ``str.isspace`` counts but the library does not), and GPT-2's byte
    alphabet."""
    lib = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    specials = [chr(lo) for lo, _ in tokmod._EXTRA_LETTER + tokmod._EXTRA_NUMBER]
    texts = TEXTS + CORPUS[:7] + [" " + c + c + "1" + c + " x" for c in specials] + [
        "a\u001cb \u001d  c", "x'sy 'll'd", "  \n  a", "\n\nb", "a \n"]
    for text in texts:
        want = [p for p, _ in lib.pre_tokenize_str(text)]
        got = ["".join(tokmod.BYTE_CHAR[b] for b in w.encode()) for w in
               tokmod.byte_level_split(text)]
        assert got == want, repr(text)
    assert sorted(tokmod.BYTE_CHAR.values()) == sorted(pre_tokenizers.ByteLevel.alphabet())


def test_unported_bpe_options_raise(tmp_path):
    base = json.loads(_train(False, False).to_str())
    cases = {
        "dropout": {"model": {**base["model"], "dropout": 0.1}},
        "byte_fallback": {"model": {**base["model"], "byte_fallback": True}},
        "fuse_unk": {"model": {**base["model"], "fuse_unk": True}},
        "continuing_subword_prefix": {"model": {**base["model"],
                                                "continuing_subword_prefix": "##"}},
        "Metaspace": {"pre_tokenizer": {"type": "Metaspace", "replacement": "▁"}},
        "NFKC": {"normalizer": {"type": "NFKC"}},
    }
    for name, patch in cases.items():
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps({**base, **patch}))
        with pytest.raises(NotImplementedError, match=name):
            UniMPTokenizer.load(str(p))
