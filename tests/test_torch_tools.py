"""The port's tools against the JAX package's, on the CPU.

The ``.pt`` converter on state dicts that the JAX ``export_state_dict``
writes from seeded JAX weights, with extra reference-named keys (a
skipped buffer, an unmatched name, a fused tensor that does not split,
an embedding of fewer rows than the target's), on ``debug`` and on tiny
GPT-NeoX and MPT configurations from ``config_from_json``: the flat trees
equal bit for bit and the three report lists equal. The exporter's state
dicts equal JAX's (names, shapes, values) for both decoder families, from
a tree and from a model (int8 kernels as their dequantized floats); a
``.pt`` of either package loads in the other to the same tree. Then the
features (float32 within 1e-5), ``cosine_topk``, the semantic IDs, the
patch VQ tokenizer, the preprocessors, the task-data derivations with
``filter_img_noise`` over JPEG, PNG, GIF, BMP, a cut JPEG and a
non-image, and the misc converters, each against the JAX function on the
same seeded inputs.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.models.config import config_from_json as j_config_from_json
from unimp_tpu.tools import convert_torch as j_convert
from unimp_tpu.tools import export_torch as j_export
from unimp_tpu.tools import features as j_features
from unimp_tpu.tools import misc_converters as j_misc
from unimp_tpu.tools import preprocess as j_pre
from unimp_tpu.tools import synth_data as j_synth
from unimp_tpu.tools import task_data as j_task
from unimp_tpu.tools import vqgan as j_vqgan
from unimp_tpu_torch.models import UniMPModel, get_config
from unimp_tpu_torch.models.config import config_from_json
from unimp_tpu_torch.tools import convert_torch, export_torch, features, misc_converters
from unimp_tpu_torch.tools import preprocess, synth_data, task_data, vqgan
from unimp_tpu_torch.tools.from_flax import flatten_tree, load_flax_params
from unimp_tpu_torch.utils.quant import dequantize_params_host, quantize_params_int8

torch.set_num_threads(2)  # six test workers share the cores
FEATURE_TOL = dict(rtol=0, atol=1e-5)

TINY = {
    "neox": {"text_config": {"model_type": "gpt_neox", "vocab_size": 256, "hidden_size": 64,
                             "num_hidden_layers": 2, "num_attention_heads": 4},
             "cross_attn_every_n_layers": 1},
    "mpt": {"text_config": {"model_type": "mpt", "vocab_size": 256, "hidden_size": 64,
                            "num_hidden_layers": 2, "num_attention_heads": 4},
            "cross_attn_every_n_layers": 2},
}
VISION = {"image_size": 28, "patch_size": 14, "hidden_size": 32, "num_hidden_layers": 1,
          "num_attention_heads": 2, "intermediate_size": 128}


def _configs(name, tmp_path):
    if name == "debug":
        return j_get_config("debug", dtype="float32"), get_config("debug", dtype="float32")
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({**TINY[name], "vision_config": VISION}))
    return (j_config_from_json(str(path)).replace(dtype="float32"),
            config_from_json(str(path)).replace(dtype="float32"))


def _jax_params(jcfg, seed):
    model = JModel(jcfg)
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(7)
    img = jcfg.vision.image_size
    params = model.init(jax.random.PRNGKey(seed), ids,
                        vision_x=jnp.zeros((1, 1, img, img, 3), jnp.float32),
                        q_media=compute_q_media(ids, 7))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_trees_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _np(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _family(jcfg):
    return "mpt" if jcfg.lm.positions == "alibi" else "neox"


@pytest.fixture(scope="module", params=["debug", "neox", "mpt"])
def weights(request, tmp_path_factory):
    jcfg, cfg = _configs(request.param, tmp_path_factory.mktemp(request.param))
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, source=_jax_params(jcfg, 0),
                target=_jax_params(jcfg, 1))


def _reference_state_dict(weights):
    """The JAX exporter's state dict plus keys a reference file holds."""
    sd = j_export.export_state_dict(weights["source"], _family(weights["jcfg"]))
    sd["unknown.param"] = np.zeros(3, np.float32)
    sd["lang_encoder.gpt_neox.layers.0.attention.rotary_emb.inv_freq"] = np.zeros(4, np.float32)
    sd["perceiver.layers.9.0.to_kv.weight"] = np.zeros((5, 3), np.float32)  # odd: no split
    emb = next(k for k in sd if k.endswith(("embed_in.weight", "wte.weight")))
    sd[emb] = sd[emb][:-8]  # the target's table has 8 rows more
    return sd


def test_convert_state_dict_equals_jax(weights):
    sd = _reference_state_dict(weights)
    want, want_report = j_convert.convert_state_dict(sd, weights["target"])
    got, report = convert_torch.convert_state_dict(sd, j_convert._flatten(weights["target"]))
    assert report == want_report
    assert "unknown.param" in report["missed"] and len(report["skipped"]) == 1
    assert any("split failed" in m for m in report["missed"])
    _assert_trees_equal(got, j_convert._flatten(want))
    model = UniMPModel(weights["cfg"])
    load_flax_params(model, got)  # the flat tree fits the port's model


def test_export_state_dict_equals_jax(weights):
    family = _family(weights["jcfg"])
    want = j_export.export_state_dict(weights["source"], family)
    _assert_trees_equal(export_torch.export_state_dict(weights["source"], family), want)
    model = UniMPModel(weights["cfg"])
    load_flax_params(model, j_convert._flatten(weights["source"]))
    _assert_trees_equal(export_torch.export_state_dict(model, family), want)
    quantize_params_int8(model, min_size=1)
    _assert_trees_equal(export_torch.export_state_dict(model, family),
                        export_torch.export_state_dict(dequantize_params_host(model), family))


def test_pt_files_load_across_packages(weights, tmp_path, capsys):
    family = _family(weights["jcfg"])
    ours, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    model = UniMPModel(weights["cfg"])
    load_flax_params(model, j_convert._flatten(weights["source"]))
    export_torch.save_torch_checkpoint(model, ours, family)
    j_export.save_torch_checkpoint(weights["source"], theirs, family)
    target = j_convert._flatten(weights["target"])
    for path in (ours, theirs):
        want = j_convert._flatten(j_convert.load_torch_checkpoint(path, weights["target"]))
        printed = capsys.readouterr().out
        got = convert_torch.load_torch_checkpoint(path, target)
        assert capsys.readouterr().out == printed  # the same [convert] lines
        _assert_trees_equal(got, want)
    bf16 = str(tmp_path / "bf16.pt")
    torch.save({"model_state_dict": {"x": torch.zeros(2, dtype=torch.bfloat16)}}, bf16)
    for load in (j_convert.load_torch_checkpoint, convert_torch.load_torch_checkpoint):
        with pytest.raises(TypeError):
            load(bf16, weights["target"] if load is j_convert.load_torch_checkpoint else target)


# ---------------------------------------------------------------- features


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    synth_data.generate(d, n_items=16, n_users=8, image_size=28, seed=0)
    return d


def test_features_equal_jax(data):
    jcfg = j_get_config("debug", dtype="float32")
    params = _jax_params(jcfg, 0)
    model = UniMPModel(get_config("debug", dtype="float32"))
    load_flax_params(model, j_convert._flatten(params))
    model.eval()
    ids = list(range(16))
    want = j_features.extract_image_features(JModel(jcfg), params, data, "beauty", ids,
                                             image_size=28, batch_size=5)
    got = features.extract_image_features(model, data, "beauty", ids, image_size=28,
                                          batch_size=5)
    assert got.shape == want.shape == (16, jcfg.vision.hidden_size)
    np.testing.assert_allclose(got, want, **FEATURE_TOL)
    texts = ["the red lipstick", "a soft face cream for the night", "item"]
    jtok = j_synth.build_tokenizer(data, n_items=16, task="rec")
    tok = synth_data.build_tokenizer(data, n_items=16, task="rec")
    want = j_features.extract_text_features(JModel(jcfg), params, jtok, texts, batch_size=2)
    got = features.extract_text_features(model, tok, texts, batch_size=2)
    np.testing.assert_allclose(got, want, **FEATURE_TOL)


def test_semantic_ids_and_retrieval_equal_jax(data, tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(50, 16)).astype(np.float32)
    np.testing.assert_array_equal(features.cosine_topk(feats, 5), j_features.cosine_topk(feats, 5))
    for kw in (dict(codes_per_level=8, last_codes=4), dict(codes_per_level=3, last_codes=2,
                                                           levels=2, seed=5)):
        want = j_features.build_semantic_ids(feats, list(range(50)), str(tmp_path / "j.json"), **kw)
        got = features.build_semantic_ids(feats, list(range(50)), str(tmp_path / "t.json"), **kw)
        assert got == want
        assert json.loads((tmp_path / "t.json").read_text()) == want
    for side, fn in (("j", j_features.add_retrieval_neighbors),
                     ("t", features.add_retrieval_neighbors)):
        d = tmp_path / side
        synth_data.generate(str(d), n_items=16, n_users=8, image_size=28, seed=0)
        fn(str(d), "beauty", feats[:16], list(range(16)), k=3)
    assert (json.loads((tmp_path / "t" / "meta_beauty.json").read_text())
            == json.loads((tmp_path / "j" / "meta_beauty.json").read_text()))


@pytest.mark.parametrize("case", ["ties", "zeros", "float32"])
def test_kmeans_assignment_equals_the_broadcast_argmin(case):
    """``_nearest`` (expanded distances, then the exact ones near the
    minimum) picks what the JAX package's [N, k, D] argmin picks, first
    index on ties, on data made of ties: rounded values, repeated rows,
    zero residuals and identical centres."""
    rng = np.random.default_rng(7)
    x = np.round(rng.normal(size=(120, 6)))
    if case == "zeros":
        x[rng.integers(0, 120, 60)] = 0.0
    if case == "float32":
        x = rng.normal(size=(120, 6)).astype(np.float32)
    centers = x[rng.choice(120, 40, replace=False)].copy()
    centers[5:9] = centers[4]
    want = ((x[:, None, :] - centers[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(features._nearest(x, centers), want)


def test_semantic_ids_with_more_items_than_codes_equal_jax(tmp_path):
    """More items than codes a level (the k-means merges items, and the
    later levels cluster non-zero residuals), with repeated items: the IDs
    equal the JAX package's."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(300, 24)).astype(np.float32)
    feats[200:260] = feats[:60]
    want = j_features.build_semantic_ids(feats, list(range(300)), str(tmp_path / "j.json"),
                                         codes_per_level=64, last_codes=8)
    got = features.build_semantic_ids(feats, list(range(300)), str(tmp_path / "t.json"),
                                      codes_per_level=64, last_codes=8)
    assert got == want
    assert len(set(v.rsplit(",", 1)[0] for v in got.values())) < 300


def test_patch_vq_tokenizer_equals_jax(data, tmp_path):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (8, 1, 1, 3), dtype=np.uint8)
    imgs = np.repeat(np.repeat(base, 64, axis=1), 64, axis=2)
    imgs = (imgs + rng.integers(0, 20, imgs.shape)).clip(0, 255).astype(np.uint8)
    kw = dict(patch=16, pca_dim=8, codebook_size=32)
    vq, jvq = vqgan.PatchVQTokenizer(**kw).fit(imgs), j_vqgan.PatchVQTokenizer(**kw).fit(imgs)
    np.testing.assert_array_equal(vq.codebook, jvq.codebook)
    toks = vq.encode(imgs)
    np.testing.assert_array_equal(toks, jvq.encode(imgs))
    np.testing.assert_array_equal(vq.decode(toks), jvq.decode(toks))
    vq.save(str(tmp_path / "cb.npz"))
    np.testing.assert_array_equal(vqgan.PatchVQTokenizer.load(str(tmp_path / "cb.npz"))
                                  .encode(imgs), toks)
    assert vqgan.parse_img_tokens("img_12 img_bad img_5000 img_3,") == [12, 3]
    # the item images' codebook and the generation dump's PNGs
    for side, mod in (("t", vqgan), ("j", j_vqgan)):
        d = tmp_path / side
        synth_data.generate(str(d), n_items=16, n_users=4, image_size=64, seed=1)
        mod.tokenize_item_images(str(d), "beauty", list(range(16)), image_size=48, seed=2)
        dump = d / "dump.json"
        dump.write_text(json.dumps([{"generated": "img_3,img_9,img_1", "target": ""},
                                    {"generated": "no tokens", "target": ""}]))
        mod.decode_generation_dump(str(dump), str(d / "vq_codebook.npz"), str(d / "out"), grid=3)
    for name in ("img_id2semantic.json", "img_tokens_full.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    for name in ("gen_0.png", "gen_1.png"):
        a, b = (np.asarray(Image.open(tmp_path / s / "out" / name)) for s in "tj")
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ preprocessing


def _amazon_raw(tmp_path):
    rng = np.random.default_rng(3)
    asins = [f"B{i:04d}" for i in range(30)]
    meta = [{"asin": a, "categories": [["Beauty", "Skin"]], "price": float(i),
             "brand": f"br{i % 4}", "title": f"thing {i}", "imUrl": f"http://x/{a}.jpg"}
            for i, a in enumerate(asins)]
    reviews = [{"asin": asins[int(rng.integers(0, 30))], "reviewerID": f"U{u}",
                "unixReviewTime": int(rng.integers(0, 10**6)), "summary": f"nice {k}",
                "overall": float(rng.integers(1, 6))}
               for u in range(40) for k in range(int(rng.integers(4, 14)))]
    mp, rp = tmp_path / "meta.json", tmp_path / "reviews.json"
    mp.write_text("\n".join(json.dumps(m) for m in meta))
    rp.write_text("\n".join(json.dumps(r) for r in reviews))
    return str(rp), str(mp)


def test_preprocessors_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    users = {f"u{i}": [[int(x), "", 3] for x in rng.integers(0, 30, rng.integers(2, 15))]
             for i in range(40)}
    assert preprocess.filter_kcore(users, 5, 4) == j_pre.filter_kcore(users, 5, 4)
    assert preprocess.check_kcore(users, 5, 4) == j_pre.check_kcore(users, 5, 4)
    raw = {f"u{i}": [[f"a{x}", "", 3] for x in rng.integers(0, 9, 4)] for i in range(20)}
    assert preprocess.reindex_items(raw) == j_pre.reindex_items(raw)
    assert preprocess.split_users(users) == j_pre.split_users(users)
    rp, mp = _amazon_raw(tmp_path)
    got = preprocess.preprocess_amazon(rp, mp, str(tmp_path / "t"), "beauty", 3, 2)
    want = j_pre.preprocess_amazon(rp, mp, str(tmp_path / "j"), "beauty", 3, 2)
    assert got == want and got["users"] > 0
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text(), name
    # H&M and Netflix
    (tmp_path / "art.csv").write_text("article_id,prod_name,graphical_appearance_name,"
                                      "colour_group_name,section_name,detail_desc\n" + "".join(
                                          f"{a},p{a},g,c,s,d{a}\n" for a in range(12)))
    (tmp_path / "tx.csv").write_text("t_dat,customer_id,article_id\n" + "".join(
        f"2020-01-{d:02d},c{c},{int(rng.integers(0, 12))}\n" for c in range(30) for d in
        range(1, 16)))
    for side, mod in (("t", preprocess), ("j", j_pre)):
        assert mod.preprocess_hm(str(tmp_path / "tx.csv"), str(tmp_path / "art.csv"),
                                 str(tmp_path / f"hm_{side}"), max_users=20, min_len=5)
    for name in sorted(os.listdir(tmp_path / "hm_j")):
        assert (tmp_path / "hm_t" / name).read_text() == (tmp_path / "hm_j" / name).read_text()
    llm = tmp_path / "llmrec"
    llm.mkdir()
    for split in ("train", "val", "test"):
        (llm / f"{split}.json").write_text(json.dumps({f"u{i}": [i, i + 1] for i in range(5)}))
    (tmp_path / "titles.csv").write_text("1,1999,A film, with a comma\n2,2001,B\n")
    got = preprocess.preprocess_netflix(str(llm), str(tmp_path / "nf_t"),
                                        str(tmp_path / "titles.csv"))
    want = j_pre.preprocess_netflix(str(llm), str(tmp_path / "nf_j"), str(tmp_path / "titles.csv"))
    assert got == want
    for name in sorted(os.listdir(tmp_path / "nf_j")):
        assert (tmp_path / "nf_t" / name).read_text() == (tmp_path / "nf_j" / name).read_text()


def test_download_images_over_file_urls(tmp_path):
    """No network: ``file://`` URLs through urllib, a missing file and an
    item without a URL skipped, an existing file kept."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jpg").write_bytes(b"jpeg bytes a")
    (src / "b.jpg").write_bytes(b"jpeg bytes b")
    meta = {"1": {"imUrl": (src / "a.jpg").as_uri()}, "2": {"imUrl": (src / "b.jpg").as_uri()},
            "3": {"imUrl": (src / "missing.jpg").as_uri()}, "4": {"imUrl": ""}}
    out = tmp_path / "out"
    out.mkdir()
    (out / "2.jpg").write_bytes(b"kept")
    assert preprocess.download_images(meta, str(out)) == 1
    assert (out / "1.jpg").read_bytes() == b"jpeg bytes a"
    assert (out / "2.jpg").read_bytes() == b"kept"
    assert sorted(os.listdir(out)) == ["1.jpg", "2.jpg"]


def _image_files(tmp_path):
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)

    def save(fmt, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr).convert("P" if fmt == "GIF" else "RGB").save(buf, fmt, **kw)
        return buf.getvalue()

    jpg = save("JPEG", quality=90)
    return {0: jpg, 1: save("PNG"), 2: save("GIF"), 3: save("BMP"), 4: jpg[:-300],
            5: b"not an image at all", 6: jpg}  # item 7 has no file


def test_task_data_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    users = {f"u{i}": [[int(j), "words here" if j % 2 else "", 3]
                       for j in rng.choice(40, 12, replace=False)] for i in range(10)}
    assert (task_data.gen_img_sel(users, set(range(40)), np.random.default_rng(5))
            == j_task.gen_img_sel(users, set(range(40)), np.random.default_rng(5)))
    for split in ("train", "eval", "test"):
        assert task_data.keep_exp(users, split) == j_task.keep_exp(users, split)
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    for item, blob in _image_files(tmp_path).items():
        (img_dir / f"{item}.jpg").write_bytes(blob)
    seqs = {f"u{i}": [[int(x), "", 3] for x in rng.integers(0, 8, 9)] for i in range(30)}
    # the JAX verdict on the cut JPEG follows PIL's process-wide flag: a
    # fresh process has it off (the port's rule), any image load turns it on
    flag = ImageFile.LOAD_TRUNCATED_IMAGES
    ImageFile.LOAD_TRUNCATED_IMAGES = False
    try:
        want = j_task.filter_img_noise(seqs, str(img_dir), user_core=3, item_core=2)
    finally:
        ImageFile.LOAD_TRUNCATED_IMAGES = flag
    got = task_data.filter_img_noise(seqs, str(img_dir), user_core=3, item_core=2)
    assert got == want
    kept = {it[0] for seq in got.values() for it in seq}
    assert {4, 5, 7}.isdisjoint(kept) and {0, 1, 2, 3} <= kept
    d = tmp_path / "derive"
    synth_data.generate(str(d), n_items=30, n_users=12, image_size=28, seed=0)
    task_data.derive_all(str(d), "beauty", 30)
    got = {n: (d / n).read_text() for n in sorted(os.listdir(d)) if n.endswith(("_img_sel.json",
                                                                                "_exp.json"))}
    j_task.derive_all(str(d), "beauty", 30)
    assert got and all((d / n).read_text() == text for n, text in got.items())


def test_misc_converters_equal_jax(tmp_path):
    base = {"a": np.ones((2, 2)), "b": {"c": np.zeros(3)}}
    target = {"a": np.full((2, 2), 3.0), "b": {"c": np.arange(3.0)}}
    delta = misc_converters.make_delta(base, target)
    jdelta = j_misc.make_delta(base, target)
    assert flatten_tree(delta).keys() == flatten_tree(jdelta).keys()
    back = misc_converters.apply_delta(base, delta)
    for k, v in flatten_tree(j_misc.apply_delta(base, jdelta)).items():
        np.testing.assert_array_equal(flatten_tree(back)[k], v)
    with pytest.raises(ValueError):
        misc_converters.apply_delta(base, {"a": np.ones((3, 2)), "b": {"c": np.zeros(3)}})
    with pytest.raises(ValueError):
        misc_converters.apply_delta(base, {"a": np.ones((2, 2))})
    recs = [{"i": i, "text": f"doc {i}"} for i in range(25)]
    got = misc_converters.shard_jsonl(recs, str(tmp_path / "t"), max_records_per_shard=10)
    want = j_misc.shard_jsonl(recs, str(tmp_path / "j"), max_records_per_shard=10)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert all(open(a).read() == open(b).read() for a, b in zip(got, want))
    data = {"SN_00_INS_s0_round0": {"rel_ins_ids": []},
            "SN_00_INS_s0_round1": {"rel_ins_ids": ["SN_00_INS_s0_round0"]},
            "LACONV_00_INS_7_0": {"rel_ins_ids": []},
            "LACONV_00_INS_7_2": {"rel_ins_ids": ["LACONV_00_INS_7_0", "LACONV_00_INS_7_1"]},
            "LACR_I2I_00_INS_b": {"rel_ins_ids": ["w"]}}
    src = tmp_path / "ins.json"
    src.write_text(json.dumps({"data": data}))
    for fn in ("build_mimicit_train_index", "llava_train_index"):
        assert (getattr(misc_converters, fn)(str(src), str(tmp_path / f"{fn}_t.json"))
                == getattr(j_misc, fn)(str(src), str(tmp_path / f"{fn}_j.json")))
    rows = [{"id": "33471", "conversations": [
        {"from": "human", "value": "<image>\nwhat is it"}, {"from": "gpt", "value": "a cat"},
        {"from": "human", "value": "what color"}, {"from": "gpt", "value": "black"}]}]
    (tmp_path / "conv.json").write_text(json.dumps(rows))
    for kw in (dict(mode="conv"), dict(mode="single", similarity={"33471": ["99", "98"]})):
        assert (misc_converters.llava_instructions_from_conversations(
            str(tmp_path / "conv.json"), str(tmp_path / "lt.json"), **kw)
            == j_misc.llava_instructions_from_conversations(
                str(tmp_path / "conv.json"), str(tmp_path / "lj.json"), **kw))
    tsv = tmp_path / "conv.tsv"
    tsv.write_text("33471_2\timg/a.jpg\tc\tq\tr\tg\tds\tt\n33471_3\timg/a.jpg\tc\tq\tr\tg\tds\tt\n"
                   "555\timg/b.jpg\tc\tq\tr\tg\tds\tt\n")
    for strip in (False, True):
        assert (misc_converters.collect_image_index([str(tsv)], str(tmp_path / "it.json"),
                                                    strip_round_suffix=strip)
                == j_misc.collect_image_index([str(tsv)], str(tmp_path / "ij.json"),
                                              strip_round_suffix=strip))
    manifest = tmp_path / "mmc4.jsonl"
    manifest.write_text("\n".join(json.dumps({"text_list": [f"t{i}"], "image_info": []})
                                  for i in range(7)) + "\n\n")
    got = misc_converters.convert_interleaved_corpus(str(manifest), str(tmp_path / "ct"),
                                                     max_records_per_shard=3)
    want = j_misc.convert_interleaved_corpus(str(manifest), str(tmp_path / "cj"),
                                             max_records_per_shard=3)
    assert [open(p).read() for p in got] == [open(p).read() for p in want]
