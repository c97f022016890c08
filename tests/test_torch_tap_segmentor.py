"""The eval scripts' models (`TapSegmentor`, five decoders: setr, unet,
unet_fuse, masktrans, setr_ete) against the JAX package's at vit_test width
on 56 px frames (`segmentor_parity.run`): the fp32 logits in eval mode, the
fp32 train step's loss (each script's: CE + DC, the mask transformer's
weighted CE + argmax dice) and BatchNorm statistics, and the step's
gradients per flax path, float64 on both sides (tap_setr_ete fp32: it
trains its backbone through the library flash attention, K7's reference,
so its backbone's gradients are among the paths). Also the mask
transformer's "imagenet_div255" input norm."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptersis_tpu.data.augment import apply_input_norm as jax_input_norm
from adaptersis_tpu_torch.data.augment import apply_input_norm
from segmentor_parity import check_gradients, check_logits, check_loss_and_stats, run
from torch_parity import n, single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

MODELS = ["tap_setr", "tap_unet", "tap_unet_fuse", "tap_masktrans", "tap_setr_ete"]


@pytest.mark.parametrize("model", MODELS)
def test_logits_match(model):
    check_logits(run(model))


@pytest.mark.parametrize("model", MODELS)
def test_train_step_loss_and_batch_stats_match(model):
    check_loss_and_stats(run(model), has_batch_norm=model != "tap_masktrans")


@pytest.mark.parametrize("model", MODELS)
def test_train_step_gradients_match(model):
    r = run(model)
    check_gradients(r)
    trained = [k for k in r["grads"][0] if k.startswith("backbone/")]
    assert bool(trained) == (model == "tap_setr_ete")
    if trained:
        assert any(r["grads"][0][k].any() for k in trained if k.startswith("backbone/blocks_"))


def test_input_norm_matches_jax():
    """imagenet_div255: ImageNet mean and std, then / 255 once more (the
    reference's double division); "none" leaves the input."""
    x = np.random.default_rng(1).uniform(0, 1, (2, 5, 5, 3)).astype(np.float32)
    for mode in ("none", "imagenet_div255"):
        np.testing.assert_allclose(n(apply_input_norm(torch.from_numpy(x), mode)),
                                   np.asarray(jax_input_norm(jnp.asarray(x), mode)),
                                   atol=1e-7, rtol=0)
    with pytest.raises(ValueError, match="input_norm"):
        apply_input_norm(torch.from_numpy(x), "imagenet")
