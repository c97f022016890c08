"""The port's whole serving slice against the JAX package: AdapterSegmentor
logits and the eval step's loss, dice and acc1, on a narrow model (embed 128,
2 heads of 64, depth 5, 112 px) with JAX's flash_fwd and msda "pallas"
kernels in interpret mode. Also the port's SyntheticSeg against the JAX one,
and the entry point's refusal to run without a GPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.data.datasets import SyntheticSeg as JaxSyntheticSeg
from adaptersis_tpu.losses import dc_loss, pixel_accuracy, weighted_ce_pair
from adaptersis_tpu.models.segmentor import AdapterSegmentor as JaxSegmentor
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu_torch import evaluate
from adaptersis_tpu_torch.data.synthetic import SyntheticSeg
from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.trainer import eval_step
from torch_parity import init_perturbed, interpret_pallas, load, n

IMG = 112
VIT = dict(img_size=56, patch_size=14, embed_dim=128, depth=5, num_heads=2)
HEAD = dict(num_classes=2, n_last_blocks=4, encoder_inplanes=16,
            decoder_features=(128, 32, 16, 16, 8))


@pytest.fixture(scope="module")
def both():
    with interpret_pallas():
        jmodel = JaxSegmentor(backbone=JaxViT(attn_impl="flash_fwd", gelu_approx=True, **VIT),
                              msda_impl="pallas", **HEAD)
        ds = SyntheticSeg(n=2, imsize=IMG, seed=3)
        imgs = np.stack([ds[i][0] for i in range(2)])
        masks = np.stack([ds[i][1] for i in range(2)])
        x = imgs.astype(np.float32) / 255.0
        variables = init_perturbed(jmodel, 11, jnp.asarray(x))
        logits = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = load(AdapterSegmentor(DinoVisionTransformer(gelu_approx=True, **VIT), **HEAD),
                 variables)
    with torch.no_grad():
        out = eval_step(model, torch.from_numpy(imgs), torch.from_numpy(masks))
    return logits, masks, out


def test_logits_match(both):
    logits, _, out = both
    assert out["logits"].shape == (2, IMG, IMG, 2) and out["logits"].dtype == torch.float32
    # ~1e-4 of the logit scale: fp32 through 5 blocks, 4 adapter rounds and the
    # decoder, with flax's E[x²] − E[x]² LayerNorm variance against torch's two-pass
    scale = np.abs(logits).max()
    np.testing.assert_allclose(n(out["logits"]), logits, atol=1e-4 * scale, rtol=0)


def test_eval_metrics_match(both):
    """The JAX trainer's per-sample metrics (train/trainer.py eval step)."""
    logits, masks, out = both
    lg, mk = jnp.asarray(logits), jnp.asarray(masks)
    per = [(lg[i:i + 1], mk[i:i + 1]) for i in range(2)]
    loss = np.mean([float(weighted_ce_pair(l, m)) for l, m in per])
    dice = np.mean([1.0 - float(dc_loss(l, m)) for l, m in per])
    acc1 = np.mean([float(pixel_accuracy(l, m)) for l, m in per])
    assert abs(float(out["loss"]) - loss) < 1e-4 * max(1.0, abs(loss))
    assert abs(float(out["dice"]) - dice) < 1e-5
    # a pixel whose two logits tie within the tolerance above may flip
    assert abs(float(out["acc1"]) - acc1) <= 4 / (IMG * IMG)
    np.testing.assert_array_equal(n(out["preds"]).shape, masks.shape)


def test_eval_step_leaves_out_invalid_rows():
    """valid=False rows (padding duplicates) do not enter the averages."""
    torch.manual_seed(0)
    model = AdapterSegmentor(DinoVisionTransformer(**VIT), **HEAD).eval()
    imgs, masks = next(SyntheticSeg(n=2, imsize=IMG, seed=8).batches(2))
    imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)
    one = eval_step(model, imgs[:1], masks[:1])
    padded = eval_step(model, imgs, masks, valid=torch.tensor([True, False]))
    for k in ("loss", "dice", "acc1"):
        torch.testing.assert_close(padded[k], one[k], rtol=1e-5, atol=1e-6)


def test_synthetic_dataset_matches_jax():
    mine, ref = SyntheticSeg(n=3, imsize=56, num_classes=3, seed=7), \
        JaxSyntheticSeg(n=3, imsize=56, num_classes=3, seed=7)
    assert len(mine) == len(ref) == 3
    for i in range(3):
        for a, b in zip(mine[i], ref[i]):
            np.testing.assert_array_equal(a, b)


def test_other_decoders_not_ported():
    """The other decoders are ported now (held against the JAX package in
    test_torch_tap_segmentor.py): both build and give logits of the input's
    size; an unknown decoder_type raises."""
    x = torch.rand(1, 56, 56, 3)
    for decoder in ("mla", "setr"):
        model = AdapterSegmentor(DinoVisionTransformer(**VIT), decoder_type=decoder,
                                 **HEAD).eval()
        with torch.no_grad():
            assert model(x).shape == (1, 56, 56, 2)
    with pytest.raises(ValueError, match="decoder_type"):
        AdapterSegmentor(DinoVisionTransformer(**VIT), decoder_type="unet")


def test_evaluate_requires_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate.main(["--arch", "vit_test", "--patch_size", "14", "--imsize", "56",
                       "--synthetic"])


def test_evaluate_loads_a_flax_variable_file(tmp_path):
    """--flax_variables: the JAX segmentor's whole variable tree, saved as one
    .npz of flax paths, loads strictly into the port's model."""
    jmodel = JaxSegmentor(backbone=JaxViT(img_size=518, patch_size=14, embed_dim=64,
                                          depth=5, num_heads=4), num_classes=2)
    variables = init_perturbed(jmodel, 4, jnp.zeros((1, 56, 56, 3), jnp.float32))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(variables)[0]}
    np.savez(tmp_path / "vars.npz", **flat)
    stats = evaluate.main(["--arch", "vit_test", "--patch_size", "14", "--imsize", "56",
                           "--batch_size_per_gpu", "2", "--synthetic", "--device", "cpu",
                           "--flax_variables", str(tmp_path / "vars.npz")])
    assert stats["logits_finite"] and np.isfinite(stats["loss"])
    flat.pop("params/level_embed")
    np.savez(tmp_path / "short.npz", **flat)
    with pytest.raises(KeyError, match="level_embed"):
        evaluate.main(["--arch", "vit_test", "--patch_size", "14", "--imsize", "56",
                       "--synthetic", "--device", "cpu",
                       "--flax_variables", str(tmp_path / "short.npz")])


def test_evaluate_plain_path_on_cpu():
    stats = evaluate.main(["--arch", "vit_test", "--patch_size", "14", "--imsize", "56",
                           "--batch_size_per_gpu", "2", "--synthetic", "--device", "cpu"])
    assert stats["logits_finite"] and stats["images"] == 4 and stats["device"] == "cpu"
    assert all(np.isfinite(stats[k]) for k in ("loss", "dice", "acc1"))
