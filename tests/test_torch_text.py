"""The port's CLIP text tower and pooled image embedding against the JAX
package's flax modules, through the weights bridge, in f32 at
rtol 2e-4, atol 2e-5:

  * models/text.py::CLIPTextEncoder against zutis_tpu/models/text.py
    (causal blocks, ln_final, the EOT token, text_projection), on ids from
    the tokenizer, truncated ones included;
  * models/vit.py::CLIPViT.encode_image against the flax `encode_image`,
    on the kernel and "torch" attention paths;
  * weights.py: `text_params_from_jax` / `visual_params_from_jax` and
    `export_params` round trip the towers;
  * factory.py: `_TEXT_SPECS`, `build_text_encoder`, `find_merges_file`
    and `load_clip_text` against `load_clip_params`' text tree on a
    synthetic OpenAI-layout checkpoint.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.data.tokenizer import CLIPTokenizer
from zutis_tpu.models import factory as jax_factory
from zutis_tpu.models.text import CLIPTextEncoder as JaxText
from zutis_tpu.models.vit import CLIPViT as JaxViT
from zutis_tpu_torch.models import factory
from zutis_tpu_torch.models.text import CLIPTextEncoder, causal_bias
from zutis_tpu_torch.models.vit import CLIPViT
from zutis_tpu_torch.models.weights import (export_params,
                                            text_params_from_jax,
                                            visual_params_from_jax)
from zutis_tpu_torch.ops import flash_attention as fa

RTOL, ATOL = 2e-4, 2e-5
TOK = CLIPTokenizer([("c", "a"), ("ca", "t</w>"), ("d", "o"), ("o", "g</w>")])
TEXT = dict(vocab_size=len(TOK.encoder), width=32, layers=2, heads=2,
            embed_dim=16)
TEXTS = ["a cat", "a photo of a dog.", "x", "the 3 cats' toys &amp; more",
         "dog " * 90]
VIT = dict(width=32, layers=2, heads=2, patch_size=8, output_dim=16,
           input_resolution=32)


@pytest.fixture(scope="module")
def text_pair():
    ids = TOK.tokenize(TEXTS)
    jm = JaxText(**TEXT)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    ours = CLIPTextEncoder(**TEXT, device="cpu")
    ours.load_state_dict(text_params_from_jax(params), strict=True)
    return jm, params, ours, ids


def test_text_tower_equals_jax(text_pair):
    jm, params, ours, ids = text_pair
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = ours(ids)
    assert got.dtype == torch.float32 and got.shape == (len(TEXTS), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # a tensor of ids gives the same
    with torch.no_grad():
        np.testing.assert_array_equal(ours(torch.from_numpy(ids)).numpy(),
                                      got.numpy())


def test_text_tower_is_causal(text_pair):
    _, _, ours, ids = text_pair
    bias = causal_bias(4, "cpu")[0, 0]
    assert torch.equal(bias == 0, torch.ones(4, 4, dtype=torch.bool).tril())
    # ids past the EOT change nothing: no position sees a later one
    later = ids.copy()
    later[0, 10:] = 7
    with torch.no_grad():
        np.testing.assert_array_equal(ours(later)[0].numpy(),
                                      ours(ids)[0].numpy())


def test_text_tower_takes_the_torch_attention_path(text_pair):
    _, _, ours, ids = text_pair
    before = fa.flash_attention.launches
    with torch.no_grad():
        ours(ids)
    assert fa.flash_attention.launches == before


def test_text_tower_refusals(text_pair):
    _, _, ours, ids = text_pair
    with pytest.raises(ValueError, match="length"):
        ours(ids[:, :10])
    too_big = ids.copy()
    too_big[0, 1] = TEXT["vocab_size"]
    with pytest.raises(ValueError, match="larger vocabulary"):
        ours(too_big)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CLIPTextEncoder(**TEXT)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_encode_image_equals_jax(impl):
    x = np.random.RandomState(0).randn(3, 3, 40, 32).astype(np.float32)
    jm = JaxViT(**VIT)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, method=JaxViT.encode_image))(params, x))
    ours = CLIPViT(**VIT, attn_impl=impl, device="cpu")
    ours.load_state_dict(visual_params_from_jax(params), strict=True)
    with torch.no_grad():
        got = ours.encode_image(torch.from_numpy(x))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_export_params_round_trips_the_towers(text_pair):
    _, params, ours, _ = text_pair
    exported = export_params(ours)
    want = text_params_from_jax(params)
    assert sorted(exported) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(exported[k], v.numpy())
    again = CLIPTextEncoder(**TEXT, device="cpu")
    again.load_state_dict({k: torch.from_numpy(v) for k, v in
                           exported.items()}, strict=True)


@pytest.mark.parametrize("arch", sorted(jax_factory._TEXT_SPECS))
def test_build_text_encoder_equals_jax(arch):
    assert factory._TEXT_SPECS[arch] == jax_factory._TEXT_SPECS[arch]
    theirs = jax_factory.build_text_encoder(arch)
    with torch.device("meta"):
        ours = factory.build_text_encoder(arch, device="cpu")
    assert ours.width == theirs.width
    assert len(ours.transformer.resblocks) == theirs.layers
    assert ours.transformer.resblocks[0].attn.heads == theirs.heads
    assert ours.text_projection.shape == (theirs.width, theirs.embed_dim)
    assert ours.token_embedding.weight.shape == (theirs.vocab_size,
                                                 theirs.width)
    assert ours.positional_embedding.shape[0] == theirs.context_length
    if arch.startswith("RN"):
        dilated = factory.build_text_encoder(f"dilated{arch}", device="cpu")
        assert dilated.text_projection.shape == ours.text_projection.shape


def test_find_merges_file_equals_jax(tmp_path):
    assert factory.find_merges_file(str(tmp_path)) is None
    for name in ("bpe_simple_vocab_16e6.txt", "bpe_simple_vocab_16e6.txt.gz"):
        (tmp_path / name).write_text("#version\n")
        assert factory.find_merges_file(str(tmp_path)) == \
            jax_factory.find_merges_file(str(tmp_path))


def synthetic_clip_pt(path, width=32, layers=2, heads=2, embed=16,
                      vocab=49408, context=77, seed=12):
    """A CLIP-layout state dict at `path` (torch.save): a tiny visual
    tower under `visual.` and a text tower of the given widths from the
    port's seeded init, stored in float16 as OpenAI's files are."""
    enc = CLIPViT(width=32, layers=1, heads=2, patch_size=16, output_dim=embed,
                  input_resolution=32, device="cpu")
    enc.init_params(torch.Generator().manual_seed(seed))
    text = CLIPTextEncoder(vocab_size=vocab, context_length=context,
                           width=width, layers=layers, heads=heads,
                           embed_dim=embed, device="cpu")
    text.init_params(torch.Generator().manual_seed(seed + 1))
    sd = {f"visual.{k}": v.half() for k, v in enc.state_dict().items()}
    sd.update({k: v.half() for k, v in text.state_dict().items()})
    sd["logit_scale"] = torch.tensor(4.6)
    torch.save(sd, path)
    return text


def test_load_clip_text_equals_load_clip_params(tmp_path):
    synthetic_clip_pt(tmp_path / "ViT-B-16.pt")
    sd = factory.load_clip_text(str(tmp_path / "ViT-B-16.pt"))
    assert not any(k.startswith("visual.") or k == "logit_scale" for k in sd)
    ours = CLIPTextEncoder(width=32, layers=2, heads=2, embed_dim=16,
                           device="cpu")
    ours.load_state_dict(sd, strict=True)
    _, text = jax_factory.load_clip_params("ViT-B/16", str(tmp_path))
    want = text_params_from_jax(jax.tree.map(np.asarray, text))
    assert sorted(want) == sorted(sd)
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_load_clip_text_refuses_a_visual_only_file(tmp_path):
    torch.save({"visual.proj": torch.zeros(2, 2)}, tmp_path / "v.pt")
    with pytest.raises(ValueError, match="no CLIP text tower"):
        factory.load_clip_text(str(tmp_path / "v.pt"))
