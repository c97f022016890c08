"""A DINOv2 `.pth` backbone in both packages: a seeded state dict in the
layout of Meta's published checkpoints (fp32, `pos_embed` for 37² patches,
`mask_token`, LayerScale γ ~ N(0, 0.1²) so that every block is live),
written with `torch.save` plain, under `teacher` with `module.backbone.`
prefixes (beside the SSL heads), and with FSDP's chunked block keys. The JAX
package's `load_dinov2_backbone_params` and the port's
`load_dinov2_backbone` must give the same parameters bit for bit, and the
two segmentors on it the same logits; register tokens, SwiGLU FFNs and
DINO-v1's blocks without LayerScale load strictly into a ViT built to
match, with the JAX package's forward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.segmentor import AdapterSegmentor as JaxSegmentor
from adaptersis_tpu.models.vit import DinoV1VisionTransformer as JaxV1
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu.train.convert import load_dinov2_backbone_params
from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.vit import DinoV1VisionTransformer, DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import (
    flatten_chunked_block_keys, flax_to_state_dict, load_dinov2_backbone,
    load_torch_state_dict)
from adaptersis_tpu_torch.train.trainer import eval_step
from torch_parity import dinov2_state_dict, init_perturbed, load, n

IMG = 112
VIT = dict(img_size=518, patch_size=14, embed_dim=128, depth=5, num_heads=2)
HEAD = dict(num_classes=2, n_last_blocks=4, encoder_inplanes=16,
            decoder_features=(128, 32, 16, 16, 8))


def layouts(sd: dict) -> dict:
    """The three ways a DINOv2 backbone is stored, with their checkpoint keys."""
    teacher = {f"module.backbone.{k}": v for k, v in sd.items()}
    teacher["module.dino_head.mlp.0.weight"] = torch.zeros(4, 128)
    chunked = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            i = int(k.split(".")[1])
            k = f"blocks.{i // 2}.{i}." + k.split(".", 2)[2]
        chunked[k] = v
    return {"plain": (sd, "teacher"),
            "teacher": ({"teacher": teacher, "student": {"x": torch.zeros(1)}}, "teacher"),
            "chunked": ({"state_dict": chunked}, "model")}


@pytest.mark.parametrize("layout", ["plain", "teacher", "chunked"])
def test_both_packages_load_the_same_parameters(tmp_path, layout):
    sd = dinov2_state_dict(VIT)
    blob, key = layouts(sd)[layout]
    path = tmp_path / "dinov2.pth"
    torch.save(blob, path)
    vit = DinoVisionTransformer(**VIT)
    load_dinov2_backbone(vit, str(path), key)
    got = vit.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    # the JAX package's flax tree, through the port's name map: the same bits
    jax_sd = flax_to_state_dict(load_dinov2_backbone_params(str(path), key), {})
    assert set(jax_sd) == set(sd)
    for k, v in sd.items():
        assert torch.equal(jax_sd[k], v), k


def test_key_normalisation_matches_the_reference_rules(tmp_path):
    sd = dinov2_state_dict(VIT)
    blob, _ = layouts(sd)["chunked"]
    torch.save({"teacher": {"module.backbone.x": torch.ones(1)}, **blob}, tmp_path / "c.pth")
    assert set(load_torch_state_dict(tmp_path / "c.pth")) == {"x"}
    flat = flatten_chunked_block_keys(load_torch_state_dict(tmp_path / "c.pth", "none"))
    assert set(flat) == set(sd)


def test_segmentor_logits_on_the_pretrained_backbone(tmp_path):
    sd = dinov2_state_dict(VIT, 3)
    path = tmp_path / "dinov2.pth"
    torch.save({"teacher": layouts(sd)["teacher"][0]["teacher"]}, path)
    jmodel = JaxSegmentor(backbone=JaxViT(**VIT), **HEAD)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    masks = (rng.uniform(size=(2, IMG, IMG)) < 0.3).astype(np.int32)
    variables = init_perturbed(jmodel, 9, jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    params = dict(variables["params"])
    params["backbone"] = load_dinov2_backbone_params(str(path))
    logits = np.asarray(jax.jit(jmodel.apply)({**variables, "params": params},
                                              jnp.asarray(imgs / 255.0, jnp.float32)))
    model = load(AdapterSegmentor(DinoVisionTransformer(**VIT), **HEAD), variables)
    before = {k: v.clone() for k, v in model.state_dict().items() if not k.startswith("backbone.")}
    load_dinov2_backbone(model.backbone, str(path))
    for k, v in model.state_dict().items():
        if not k.startswith("backbone."):
            assert torch.equal(v, before[k]), k          # the trainables stay as they were
    with torch.no_grad():
        out = eval_step(model, torch.from_numpy(imgs), torch.from_numpy(masks))
    # the segmentors' fp32 tolerance (test_torch_segmentor): 1e-4 of the
    # logit scale
    scale = np.abs(logits).max()
    np.testing.assert_allclose(n(out["logits"]), logits, atol=1e-4 * scale, rtol=0)


# the other DINOv2 layouts: register tokens, SwiGLU FFNs (ViT-g's w12 / w3)
# and DINO-v1's blocks without LayerScale
VARIANTS = {"registers": dict(num_register_tokens=4), "swiglu": dict(ffn_layer="swiglufused"),
            "v1": dict(init_values=None)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_other_backbones_load_strictly(tmp_path, variant):
    """A `.pth` of each layout loads strictly into a ViT built to match, and
    its forward equals the JAX package's on the JAX converter's parameters
    (the v1 backbone's own forward: the normed patch tokens)."""
    kw = {**VIT, **VARIANTS[variant]}
    v1 = variant == "v1"
    sd = dinov2_state_dict(kw, seed=4)
    if variant == "registers":
        assert sd["register_tokens"].shape == (1, 4, 128)
    torch.save({"teacher": {f"backbone.{k}": v for k, v in sd.items()}}, tmp_path / "v.pth")
    vit = (DinoV1VisionTransformer if v1 else DinoVisionTransformer)(**kw)
    load_dinov2_backbone(vit, str(tmp_path / "v.pth"))
    for k, v in vit.state_dict().items():
        assert torch.equal(v, sd[k]), k
    x = np.random.default_rng(6).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    jvit = (JaxV1 if v1 else JaxViT)(**kw)
    want = jvit.apply({"params": load_dinov2_backbone_params(str(tmp_path / "v.pth"))},
                      jnp.asarray(x))
    with torch.no_grad():
        got = vit(torch.from_numpy(x))
    if v1:
        got, want = {"patch": got}, {"patch": want}
    assert set(got) == set(want)
    for k, e in want.items():
        # fp32 on both sides (test_torch_vit's tolerance)
        np.testing.assert_allclose(n(got[k]), np.asarray(e), atol=2e-5, rtol=0, err_msg=k)


def test_a_missing_or_misshapen_key_raises(tmp_path):
    sd = dinov2_state_dict(VIT)
    del sd["mask_token"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="Missing key.*mask_token"):
        load_dinov2_backbone(DinoVisionTransformer(**VIT), str(tmp_path / "short.pth"))
    sd = dinov2_state_dict(VIT)
    sd["pos_embed"] = torch.zeros(1, 257, 128)
    torch.save(sd, tmp_path / "grid.pth")
    with pytest.raises(RuntimeError, match="size mismatch for pos_embed"):
        load_dinov2_backbone(DinoVisionTransformer(**VIT), str(tmp_path / "grid.pth"))
