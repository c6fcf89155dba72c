"""The port's instruct and web datasets against the JAX package's.

``data/instruct_dataset.py``: ``pre_question`` / ``pre_answer``, every
per-source renderer through ``render_mimicit_sample`` under several
``random.Random`` seeds, ``MultiInstructDataset`` items (the same text,
token ids and image bytes, MIMIC-IT and generic ids), and ``FileDataset``
rank slices. ``data/webdata.py``: ``ShardedJsonlDataset`` orders over two
epochs (shuffled and resampled shards, per-host shards, small and large
shuffle buffers), with corrupt records and an unreadable shard handed to
``log_and_continue``.
"""

import json
import os
import random

import numpy as np
import pytest

from unimp_tpu.data import instruct_dataset as j_ins
from unimp_tpu.data import webdata as j_web
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu_torch.data import instruct_dataset as t_ins
from unimp_tpu_torch.data import webdata as t_web
from unimp_tpu_torch.data.tokenizer import UniMPTokenizer

STORE = {
    "LA_1": {"instruction": "What-COLOR/is it?", "answer": "Deep blue. Like the sea",
             "image_ids": ["imgA", "imgX"]},
    "LA_2": {"instruction": ",.!?*#:;~Odd   spacing\n", "answer": "   two  spaces.  ",
             "image_ids": ["imgB"]},
    "LA_3": {"instruction": "plain", "answer": "word " * 300, "image_ids": ["imgC"]},
    "DC_1": {"instruction": "Describe densely", "answer": "A. B. C", "image_ids": ["d1", "d2"]},
    "E4D_1": {"instruction": "events?", "answer": "many", "image_ids": ["e1"]},
    "SD_9": {"instruction": "spot the difference", "answer": "left lamp",
             "image_ids": ["s1", "s2"]},
    "SN_4": {"instruction": "navigate", "answer": "go left", "image_ids": ["n1"]},
    "FunQA_7": {"instruction": "why funny", "answer": "slapstick", "image_ids": ["f1", "f2"]},
    "LA_noimg": {"instruction": "no images", "answer": "none"},
    "ZZ_0": {"instruction": "other source", "answer": "plain", "image_ids": ["z"]},
}
CONTEXT = {"LA_1": ["LA_2", "LA_3"], "DC_1": ["LA_1", "SD_9"], "E4D_1": ["DC_1"],
           "SD_9": ["LA_1"], "SN_4": ["LA_1", "DC_1"], "FunQA_7": ["SN_4", "E4D_1"],
           "LA_2": ["LA_noimg"], "ZZ_0": ["LA_1"]}


def test_text_normalizers_match_jax():
    rng = np.random.default_rng(0)
    words = ["What-COLOR/is", "it?", ",.!?", "Deep", "blue.", "Like", "the", "sea.", "  ",
             "\n", "A.", "B", "word", "x/y", "-", "one two."]
    texts = [" ".join(rng.choice(words, rng.integers(0, 30))) for _ in range(200)]
    texts += ["", "   ", "word " * 300, "nodots at all", "A. B. C"]
    for s in texts:
        for mw in (1, 3, 4, 256):
            assert t_ins.pre_question(s, mw) == j_ins.pre_question(s, mw), (s, mw)
            assert t_ins.pre_answer(s, mw) == j_ins.pre_answer(s, mw), (s, mw)


@pytest.mark.parametrize("seed", [0, 1, 3, 17])
def test_rendered_samples_match_jax(seed):
    for sid, rel in CONTEXT.items():
        jr, tr = random.Random(seed), random.Random(seed)
        want = j_ins.render_mimicit_sample(STORE, sid, rel, jr)
        got = t_ins.render_mimicit_sample(STORE, sid, rel, tr)
        if want is None:
            assert got is None, sid
        else:
            assert (got.text, got.image_groups) == (want.text, want.image_groups), sid
        assert jr.random() == tr.random()  # the stream advanced alike
        for max_src, max_tgt in ((2, 3), (256, 4)):
            for fn_name in ("process_llava", "process_dense_caption", "process_e4d",
                            "process_funqa", "process_spot_the_difference",
                            "process_scene_navigation"):
                if any("image_ids" not in STORE[s] for s in rel + [sid]):
                    continue
                w = getattr(j_ins, fn_name)(STORE, sid, rel, random.Random(seed),
                                            max_src=max_src, max_tgt=max_tgt)
                g = getattr(t_ins, fn_name)(STORE, sid, rel, random.Random(seed),
                                            max_src=max_src, max_tgt=max_tgt)
                assert (g.text, g.image_groups) == (w.text, w.image_groups), (fn_name, sid)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("instruct"))
    j_synth.generate(d, n_items=16, n_users=8, image_size=28)
    jtok = j_synth.build_tokenizer(d, n_items=16)
    path = os.path.join(d, "tok.json")
    jtok.save(path)
    ann = {"data": {
        "LA_1": {"instruction": "what color is it", "answer": "blue. like the sea",
                 "image_ids": [0], "rel_ins_ids": ["LA_2", "missing"]},
        "LA_2": {"instruction": "what shape", "answer": "round", "image_ids": [1],
                 "rel_ins_ids": []},
        "DC_1": {"instruction": "describe densely", "answer": "a cream. a serum",
                 "image_ids": [2, 3], "rel_ins_ids": ["LA_1", "LA_2", "SD_9"]},
        "SD_9": {"instruction": "spot the difference", "answer": "the lamp",
                 "image_ids": [4, 5], "rel_ins_ids": ["LA_1"]},
        "x": {"instruction": "generic id", "answer": "soft", "image_ids": [6],
              "rel_ins_ids": ["y"]},
        "y": {"instruction": "no images", "answer": "none", "rel_ins_ids": []},
    }}
    ann_path = os.path.join(d, "ann.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return d, jtok, UniMPTokenizer.load(path), ann_path


@pytest.mark.parametrize("max_incontext", [1, 2])
def test_multi_instruct_items_match_jax(data, max_incontext):
    d, jtok, ttok, ann_path = data
    img_dir = os.path.join(d, "beauty")
    kw = dict(max_incontext=max_incontext, image_size=28, seed=5)
    jds = j_ins.MultiInstructDataset(ann_path, img_dir, jtok, **kw)
    tds = t_ins.MultiInstructDataset(ann_path, img_dir, ttok, **kw)
    assert len(tds) == len(jds) == 6 and tds.keys == jds.keys
    for _ in range(2):  # the chain stream carries on across passes
        for i in range(len(jds)):
            want, got = jds[i], tds[i]
            assert got.keys() == want.keys()
            np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
            assert got["input_ids"].dtype == want["input_ids"].dtype
            np.testing.assert_array_equal(got["images"], want["images"])
            assert (got["weight"], got["task"]) == (want["weight"], want["task"])


def test_file_dataset_rank_slices_match_jax(tmp_path):
    tsv = tmp_path / "rows.tsv"
    tsv.write_text("".join(f"{i}\tcol{i}\textra{i}\n" for i in range(11)))
    for world in (1, 2, 3):
        for rank in range(world):
            for cols in (None, "0,2", "1"):
                j = j_ins.FileDataset(str(tsv), selected_cols=cols, rank=rank, world_size=world)
                t = t_ins.FileDataset(str(tsv), selected_cols=cols, rank=rank, world_size=world)
                assert len(t) == len(j)
                assert list(t) == list(j)


def _shards(tmp_path, n_shards=4, per_shard=9):
    for s in range(n_shards):
        lines = [json.dumps({"shard": s, "i": i}) for i in range(per_shard)]
        if s == 1:
            lines.insert(3, "{not json")
            lines.insert(5, "")
        (tmp_path / f"shard-{s:03d}.jsonl").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "shard-*.jsonl")


@pytest.mark.parametrize("resampled", [False, True])
@pytest.mark.parametrize("buffer", [1, 5, 1000])
def test_sharded_jsonl_orders_match_jax(tmp_path, capsys, resampled, buffer):
    pattern = _shards(tmp_path)
    for hosts in (1, 2):
        for host in range(hosts):
            kw = dict(seed=3, shuffle_buffer=buffer, resampled=resampled,
                      process_index=host, process_count=hosts)
            j = j_web.ShardedJsonlDataset(pattern, **kw)
            t = t_web.ShardedJsonlDataset(pattern, **kw)
            for epoch in (0, 1):
                j.set_epoch(epoch)
                t.set_epoch(epoch)
                got, want = list(t), list(j)
                assert got == want and got
    if not resampled:  # a resampled epoch may never draw the corrupt shard
        assert "caught JSONDecodeError" in capsys.readouterr().out


def test_unreadable_shard_and_raising_handler(tmp_path, capsys):
    pattern = _shards(tmp_path, n_shards=2)
    os.mkdir(tmp_path / "shard-009.jsonl")  # a directory: open raises IsADirectoryError
    t = t_web.ShardedJsonlDataset(pattern, seed=1)
    j = j_web.ShardedJsonlDataset(pattern, seed=1)
    assert list(t) == list(j)
    assert "IsADirectoryError" in capsys.readouterr().out

    def strict(exn):
        return False

    with pytest.raises(json.JSONDecodeError):
        list(t_web.ShardedJsonlDataset(pattern, seed=1, handler=strict))
    with pytest.raises(FileNotFoundError):
        t_web.ShardedJsonlDataset(str(tmp_path / "none-*.jsonl"))
