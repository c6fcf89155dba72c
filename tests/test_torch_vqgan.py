"""The port's VQGAN decoder against the JAX package's, on the CPU.

The tiny taming-transformers decoder of ``tests/test_vqgan_decoder.py``
(ch 32, ch_mult (1, 2), one ResnetBlock a level plus one, attention at the
lowest level and in the middle) with seeded weights: the port's
``VQGANDecoder`` on its state dict against the JAX decoder, float32 within
1e-5, and against the torch module itself; the architecture read from the
keys; ``decode``'s uint8 images and ``decode_img_gen_dump``'s PNGs against
the JAX ones (within one level: the float images agree to 1e-5, and a
pixel on a rounding edge may fall either way).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_vqgan_decoder import TinyTamingDecoder

from unimp_tpu.tools.vqgan_decoder import VQGANDecoder as JDecoder
from unimp_tpu.tools.vqgan_decoder import decode_img_gen_dump as j_decode_dump
from unimp_tpu_torch.tools.vqgan import PatchVQTokenizer
from unimp_tpu_torch.tools.vqgan_decoder import VQGANDecoder, decode_img_gen_dump

TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def decoders():
    torch.manual_seed(0)
    ref = TinyTamingDecoder().eval()
    sd = ref.state_dict()
    with torch.no_grad():  # taming's GroupNorm affine starts at 1 / 0: move it off
        for k, v in sd.items():
            if "norm" in k:
                v.add_(torch.randn_like(v) * 0.1)
    sd["encoder.conv_in.weight"] = torch.zeros(4, 3, 3, 3)  # dropped: not the decoder's
    return ref, VQGANDecoder.from_state_dict(sd), JDecoder.from_state_dict(sd)


def test_decoder_equals_jax_and_torch(decoders):
    ref, dec, jdec = decoders
    codes = np.random.default_rng(0).integers(0, 16, size=(3, 16))  # 4 x 4 -> 8 x 8
    with torch.no_grad():
        got = dec(torch.from_numpy(codes)).numpy()
        want_torch = ref(torch.from_numpy(codes)).numpy()
    want = np.asarray(jdec._decode(codes.astype(np.int32))).transpose(0, 3, 1, 2)
    assert got.shape == want.shape == (3, 3, 8, 8)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, want_torch, **TOL)
    img, jimg = dec.decode(codes), jdec.decode(codes.astype(np.int32))
    assert img.dtype == np.uint8 and img.shape == jimg.shape == (3, 8, 8, 3)
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1


def test_architecture_inference(decoders):
    _, dec, jdec = decoders
    assert (dec.num_levels, dec.blocks_per_level, dec.attn_levels) == (
        jdec.num_levels, jdec.blocks_per_level, jdec.attn_levels) == (2, {0: 2, 1: 2}, {1})
    assert (dec.n_embed, dec.embed_dim) == (jdec.n_embed, jdec.embed_dim) == (16, 8)
    assert not any(k.startswith("encoder.") for k in dec.keys)


def test_decode_img_gen_dump_equals_jax(decoders, tmp_path):
    _, dec, jdec = decoders
    dump = [{"generated": "img_1, img_2, img_3, img_4,", "target": "x"},
            {"generated": "no tokens here", "target": "y"},
            {"generated": "img_0, img_5, img_6,", "target": "z"}]  # padded to 2 x 2
    p = tmp_path / "img_gen_0.json"
    p.write_text(json.dumps(dump))
    assert decode_img_gen_dump(str(p), dec, str(tmp_path / "t")) == 2
    assert j_decode_dump(str(p), jdec, str(tmp_path / "j")) == 2
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
        "gen_0.png", "gen_2.png"]
    for name in ("gen_0.png", "gen_2.png"):
        a, b = (np.asarray(Image.open(tmp_path / s / name)).astype(int) for s in "tj")
        assert a.shape == b.shape == (4, 4, 3) and np.abs(a - b).max() <= 1


def test_from_torch_checkpoint(decoders, tmp_path):
    ref, dec, _ = decoders
    path = tmp_path / "vqgan.ckpt"
    torch.save({"state_dict": ref.state_dict(), "global_step": 7}, path)
    loaded = PatchVQTokenizer.from_torch_vqgan(str(path))
    codes = torch.arange(16).reshape(1, 16)
    with torch.no_grad():
        np.testing.assert_allclose(loaded(codes).numpy(), ref(codes).numpy(), **TOL)
