"""The port's data layer against the JAX package's, on the CPU.

Tokenizer (pure Python vs the ``tokenizers`` library the JAX package
wraps): identical ids, decode strings and lengths on the synth corpus,
every eval prompt and a property test over mixed Unicode; ``tokenizer.json``
read across. JPEG: the port's numpy codec against libjpeg (PIL and the
JAX package's native pipe) bit for bit. Vocab, prompts, dataset, collate,
loader and the synth writer: identical arrays and files.
"""

import filecmp
import io
import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image
from tokenizers import Tokenizer
from tokenizers.models import WordLevel
from tokenizers.pre_tokenizers import Punctuation, Whitespace
from tokenizers.pre_tokenizers import Sequence as PreSeq

from unimp_tpu.data import collate as j_collate
from unimp_tpu.data import loader as j_loader
from unimp_tpu.data import transforms as j_transforms
from unimp_tpu.data.dataset import TaskDataset as JTaskDataset
from unimp_tpu.data.tokenizer import UniMPTokenizer as JTokenizer
from unimp_tpu.data.vocab import extend_vocabulary as j_extend
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu_torch.data import collate, jpeg, loader, tokenizer, transforms
from unimp_tpu_torch.data.dataset import TaskDataset
from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
from unimp_tpu_torch.data.vocab import extend_vocabulary
from unimp_tpu_torch.tools import synth_data

N_ITEMS = 40


@pytest.fixture(scope="module")
def beauty(tmp_path_factory):
    """The beauty subset's own item count, text only: corpus and users."""
    d = str(tmp_path_factory.mktemp("beauty"))
    synth_data.generate(d, subset="beauty", n_items=4167, n_users=288, seed=0,
                        write_images=False)
    return d


@pytest.fixture(scope="module")
def tokenizers_pair(beauty):
    """(JAX, port) corpus tokenizers with every task token (items and
    img_*, tokens)."""
    with open(os.path.join(beauty, "corpus.txt")) as f:
        corpus = f.read().splitlines()
    j, t = JTokenizer.from_corpus(corpus), UniMPTokenizer.from_corpus(corpus)
    assert j_extend(j, subset="beauty") == extend_vocabulary(t, subset="beauty")
    return j, t


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A small dataset with images (28 px, the debug tower's size), written
    by the JAX writer (PIL JPEGs) and by the port's (its own encoder)."""
    root = tmp_path_factory.mktemp("small")
    j_synth.generate(str(root / "jax"), n_items=N_ITEMS, n_users=48, image_size=28, seed=0)
    synth_data.generate(str(root / "port"), n_items=N_ITEMS, n_users=48, image_size=28, seed=0)
    return root


# ---------------------------------------------------------------- tokenizer


def _same(j, t, text):
    ids = t.encode(text)
    assert ids == j.encode(text), text
    assert t.decode(ids) == j.decode(ids), text
    assert t.decode(ids, skip_special_tokens=False) == j.decode(ids, skip_special_tokens=False)


def test_tokenizer_matches_on_corpus_and_prompts(beauty, tokenizers_pair):
    j, t = tokenizers_pair
    assert len(t) == len(j)
    for name in ("pad", "unk", "bos", "eos", "media", "endofchunk", "answer"):
        assert getattr(t, f"{name}_token_id") == getattr(j, f"{name}_token_id")
    with open(os.path.join(beauty, "corpus.txt")) as f:
        for line in f.read().splitlines():
            _same(j, t, line)
    ds = TaskDataset(beauty, "beauty", "rec", "test", t, n_items=4167, load_images=False)
    for rec in ds.records:
        sample = ds.builder.eval_rec(rec)
        _same(j, t, sample.text)
        assert t.encode(sample.text, add_bos=True, add_eos=True) == \
            j.encode(sample.text, add_bos=True, add_eos=True)


@pytest.mark.parametrize("text,pieces", [
    ("item_3item_17", ["item_3", "item_17"]),
    ("xitem_12y", ["x", "item_12", "y"]),
    ("img_789,", ["img_789,"]),
    ("a_b", ["a", "_", "b"]),
    ("€€ a™b", ["€€", "a", "™", "b"]),
    ("a①", ["a", "①"]),
    ("x²y", ["x", "²", "y"]),
    ("ét", ["ét"]),
])
def test_tokenizer_splits_as_the_library(tokenizers_pair, text, pieces):
    """The cases the Rust library splits unlike Python's re (checked with
    it here): the port gives the library's ids and pieces."""
    j, t = tokenizers_pair
    _same(j, t, text)
    got = [p for piece, tid in t._split_added(text)
           for p in ([t.id_to_token(tid)] if tid is not None else tokenizer.pre_tokenize(piece))]
    assert got == pieces


_ITEMS = [f"item_{i}" for i in (0, 3, 12, 17, 123, 4166)] + ["item_last_3", "img_7,", "img_789,",
                                                             "img_1023,"]
_SPECIALS = ["<image>", "<answer>", "<|endofchunk|>", "<s>", "</s>", "<pad>", "<unk>"]
_PIECES = st.one_of(
    st.sampled_from(_ITEMS + _SPECIALS),
    st.sampled_from(list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")),
    st.sampled_from([" ", "  ", "\t", "\n", " 　 ", " "]),
    st.sampled_from(["Category", "MAKEUP", "lumera", "serum", "img", "item", "rate_3", "s_2", "12"]),
    st.sampled_from(["é", "ß", "Ω", "日本", "́", "̈", "²", "³", "①", "⑳", "Ⓐ", "€", "™",
                     "©", "∑", "‍", "ั", "١٢", "x́"]),
    st.characters(blacklist_categories=("Cs",)),
)


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(_PIECES, max_size=16).map("".join))
def test_tokenizer_property_matches_the_library(tokenizers_pair, text):
    j, t = tokenizers_pair
    _same(j, t, text)


def test_char_classes_match_the_library():
    """Every code point of the Basic Multilingual Plane, every one of the
    exception ranges and a stride through the others: the port's
    pre-tokenizer cuts where the library's does."""
    tk = Tokenizer(WordLevel({"<unk>": 0}, unk_token="<unk>"))
    tk.pre_tokenizer = PreSeq([Whitespace(), Punctuation()])
    cps = set(range(0x10000)) | set(range(0x10000, 0x110000, 97))
    for lo, hi in tokenizer._EXTRA_WORD + tokenizer._EXTRA_OTHER + tokenizer._EXTRA_PUNCT:
        cps |= set(range(lo, hi + 1))
    chars = [chr(c) for c in sorted(cps) if not 0xD800 <= c <= 0xDFFF]
    for probe in ("a{}", "€{}", "{}a", " {} "):
        texts = [probe.format(ch) for ch in chars]
        want = [[text[a:b] for a, b in e.offsets]
                for text, e in zip(texts, tk.encode_batch(texts, add_special_tokens=False))]
        got = [tokenizer.pre_tokenize(text) for text in texts]
        bad = [(t, w, g) for t, w, g in zip(texts, want, got) if w != g]
        assert not bad, bad[:5]


def test_tokenizer_json_round_trips(tmp_path, tokenizers_pair):
    """A file of the JAX ``save`` read by the port's ``load`` gives the same
    ids (``<answer>`` is then kept by decode on both sides), and the
    port's ``save`` reads back into the library."""
    j, t = tokenizers_pair
    text = "<image> Category makeup lipstick item_3 <|endofchunk|> next? <answer> item_17item_3"
    j.save(str(tmp_path / "jax.json"))
    t2 = UniMPTokenizer.load(str(tmp_path / "jax.json"))
    j2 = JTokenizer.load(str(tmp_path / "jax.json"))
    assert len(t2) == len(j)
    _same(j2, t2, text)
    assert "<answer>" in t2.decode(t2.encode(text)) and "<answer>" not in t.decode(t.encode(text))
    t.save(str(tmp_path / "port.json"))
    j3 = JTokenizer.load(str(tmp_path / "port.json"))
    assert len(j3) == len(j) and j3.encode(text) == j.encode(text)


def test_tokenizer_add_tokens_like_the_library():
    """Known tokens keep their ids, repeats are skipped, new ones count on
    from the vocabulary, and the counts returned agree."""
    vocab = {"<pad>": 0, "<unk>": 1, "<s>": 2, "</s>": 3, "what": 4, "item_3": 5}
    j, t = JTokenizer.from_vocab(vocab), UniMPTokenizer.from_vocab(vocab)
    for toks, special in ((["what", "item_3", "item_4"], False), (["item_4"], False),
                          (["item_4"], True), (["item_5", "item_5"], True), (["", "x"], False)):
        assert t.add_tokens(toks, special=special) == j.add_tokens(toks, special=special)
    assert len(t) == len(j)
    for tok in ("what", "item_3", "item_4", "item_5", "x", "<image>"):
        assert t.convert_tokens_to_ids(tok) == j.convert_tokens_to_ids(tok)
    _same(j, t, "whatitem_3item_4 xitem_4y what, <image>item_5")


def test_unported_tokenizers_raise(tmp_path):
    """Models other than WordLevel and byte-level BPE raise, naming
    themselves, through ``load`` and ``from_hf`` alike (byte-level BPE
    reads since it was ported: ``tests/test_torch_bpe.py``)."""
    for kind in ("Unigram", "WordPiece"):
        (tmp_path / f"{kind}.json").write_text(json.dumps({"model": {"type": kind}}))
        for read in (UniMPTokenizer.load, UniMPTokenizer.from_hf):
            with pytest.raises(NotImplementedError, match=kind):
                read(str(tmp_path / f"{kind}.json"))


@pytest.mark.parametrize("kw", [dict(subset="beauty"), dict(subset="netflix"),
                                dict(subset="beauty", use_semantic=True),
                                dict(subset="beauty", task="img_gen"),
                                dict(subset="beauty", task="rec", transfer_domain="office")])
def test_extend_vocabulary_matches(kw):
    j = JTokenizer.from_corpus(["hello world item_3 rate_1"])
    t = UniMPTokenizer.from_corpus(["hello world item_3 rate_1"])
    assert extend_vocabulary(t, **kw) == j_extend(j, **kw)
    assert len(t) == len(j)
    for tok in ("<answer>", "item_0", "item_3", "rate_5", "s_4", "img_3,", "item_last_7",
                "item_domain_9", "hello"):
        assert t.token_to_id(tok) == j._tk.token_to_id(tok)


# ---------------------------------------------------------------- images


def _pil_jpeg(arr, quality):
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _images(rng):
    for h, w in ((32, 32), (28, 28), (17, 23), (40, 40), (9, 31), (1, 1), (100, 37)):
        yield rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        yield np.stack([(yy * 7 + xx * 3) % 256, (xx * 11) % 256, yy * 2 + 40], -1).astype(np.uint8)


@pytest.mark.parametrize("quality", [50, 85, 95])
def test_jpeg_codec_matches_libjpeg(quality):
    """Decode: equal to PIL's libjpeg decode; encode: the same bytes as
    PIL's save (4:2:0, standard tables), at odd sizes and 1 x 1 too."""
    for arr in _images(np.random.default_rng(quality)):
        data = _pil_jpeg(arr, quality)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
        assert jpeg.encode_jpeg(arr, quality) == data


def test_jpeg_decodes_grayscale_444_and_422():
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 255, (19, 26), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(gray, "L").save(buf, format="JPEG", quality=85)
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode_jpeg(buf.getvalue()), want)
    arr = rng.integers(0, 255, (21, 18, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="JPEG", quality=90, subsampling=0)
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode_jpeg(buf.getvalue()), want)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="JPEG", quality=90, subsampling=1)  # 4:2:2
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode_jpeg(buf.getvalue()), want)
    buf = io.BytesIO()  # progressive: decoded since fault 5 was fixed (test_torch_images.py)
    Image.fromarray(arr, "RGB").save(buf, format="JPEG", quality=90, progressive=True)
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode_jpeg(buf.getvalue()), want)


@pytest.mark.parametrize("size", [28, 224])
def test_load_resized_uint8_bit_exact(small, size):
    """The port's decode + resize equals the JAX package's native pipe (or
    its PIL path where the pipe is not built), bit for bit."""
    img_dir = small / "jax" / "beauty"
    extra = small / "odd.jpg"
    extra.write_bytes(_pil_jpeg(np.random.default_rng(5).integers(0, 255, (17, 45, 3),
                                                                  dtype=np.uint8), 85))
    for path in [img_dir / f"{i}.jpg" for i in range(0, N_ITEMS, 3)] + [extra]:
        got = transforms.load_resized_uint8(str(path), size)
        want = j_transforms.load_resized_uint8(str(path), size)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)


def test_synth_writer_matches_jax(small):
    """JSON and corpus byte for byte; JPEGs byte for byte too (so their
    decoded pixels are equal, max |delta| 0)."""
    jax_dir, port_dir = small / "jax", small / "port"
    names = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(port_dir) for p in port_dir.rglob("*") if p.is_file())
    assert len(names) == N_ITEMS + 16
    for name in names:
        assert filecmp.cmp(jax_dir / name, port_dir / name, shallow=False), name
    for i in range(N_ITEMS):
        np.testing.assert_array_equal(
            transforms.load_image_rgb(str(port_dir / "beauty" / f"{i}.jpg")),
            np.asarray(Image.open(jax_dir / "beauty" / f"{i}.jpg").convert("RGB")))


# ---------------------------------------------------------------- dataset, collate, loader


@pytest.fixture(scope="module")
def small_tokenizers(small):
    d = str(small / "port")
    return (j_synth.build_tokenizer(d, n_items=N_ITEMS, task="rec"),
            synth_data.build_tokenizer(d, n_items=N_ITEMS, task="rec"))


def _datasets(small, small_tokenizers, task, load_images, **kw):
    jt, t = small_tokenizers
    d = str(small / "port")
    return (JTaskDataset(d, "beauty", task, "test", jt, n_items=N_ITEMS, image_size=28,
                         history_len=5, load_images=load_images, **kw),
            TaskDataset(d, "beauty", task, "test", t, n_items=N_ITEMS, image_size=28,
                        history_len=5, load_images=load_images, **kw))


def _assert_same_sample(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("task", ["rec", "search"])
@pytest.mark.parametrize("load_images", [False, True])
def test_dataset_items_match(small, small_tokenizers, task, load_images):
    jds, ds = _datasets(small, small_tokenizers, task, load_images)
    assert len(ds) == len(jds) == 8 and ds.n_items == jds.n_items
    for i in range(len(ds)):
        _assert_same_sample(jds[i], ds[i])


def test_unported_tasks_raise(small, small_tokenizers):
    """The tasks that raised before they were ported now read their own
    files and give the JAX package's samples; an unknown task raises."""
    for task in ("exp", "img_sel", "img_gen"):
        jds, ds = _datasets(small, small_tokenizers, task, False)
        assert len(ds) == len(jds) == 8 and ds.records == jds.records
        for i in range(len(ds)):
            _assert_same_sample(jds[i], ds[i])
    with pytest.raises(KeyError):
        TaskDataset(str(small / "port"), "beauty", "vqa", "test", small_tokenizers[1])


def _assert_same_batch(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("load_images", [False, True])
def test_collate_and_loader_match(small, small_tokenizers, load_images):
    jds, ds = _datasets(small, small_tokenizers, "rec", load_images)
    samples = [ds[i] for i in range(5)]
    for kw in (dict(pad_to_multiple=64), dict(pad_to_multiple=128, max_text_len=96, fixed_media=6)):
        _assert_same_batch(j_collate.collate_batch(samples, 0, **kw),
                           collate.collate_batch(samples, 0, **kw))
    for workers in (0, 2):
        for kw in (dict(shuffle=False, drop_last=False), dict(shuffle=True, seed=3)):
            jl = j_loader.DataLoader(jds, 3, 0, num_workers=workers, pad_to_multiple=128, **kw)
            tl = loader.DataLoader(ds, 3, 0, num_workers=workers, pad_to_multiple=128, **kw)
            jb, tb = list(jl), list(tl)
            assert len(tb) == len(jb) == len(tl) > 0
            for a, b in zip(jb, tb):
                _assert_same_batch(a, b)
