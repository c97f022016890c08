"""The port in the JAX package's deployed configuration of the frozen walks
(`bench.py`, `tools/bench_infer.py`: attn_impl "flash_fwd", qkv_impl,
mlp_impl and ln_impl "pallas", msda_impl "pallas"), with the JAX Pallas
kernels in interpret mode: the Block with tanh GELU (fused LN → MLP) and
with exact GELU (LayerNorm on norm2 and the plain Mlp), the ViT pieces, and
on a narrow model (embed 128, 2 heads of 64, depth 5, 112 px, fp32) the
AdapterSegmentor's logits, the eval step's metrics, and one train step's
loss and per-flax-path gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.losses import LOSSES, dc_loss, pixel_accuracy, weighted_ce_pair
from adaptersis_tpu.models.layers import Block as JaxBlock
from adaptersis_tpu.models.segmentor import AdapterSegmentor as JaxSegmentor
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu_torch.data.synthetic import SyntheticSeg
from adaptersis_tpu_torch.models.layers import Block
from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import state_dict_to_flax
from adaptersis_tpu_torch.train.trainer import Trainer, eval_step
from torch_parity import init_perturbed, interpret_pallas, load, n, t

DEPLOYED = dict(attn_impl="flash_fwd", qkv_impl="pallas", mlp_impl="pallas", ln_impl="pallas")
IMG = 112
VIT = dict(img_size=56, patch_size=14, embed_dim=128, depth=5, num_heads=2)
HEAD = dict(num_classes=2, n_last_blocks=4, encoder_inplanes=16,
            decoder_features=(128, 32, 16, 16, 8))
# fp32 on both sides, both LayerNorms in the fast-variance form; the sums
# run in other orders (as in test_torch_vit)
ATOL = 2e-5


@pytest.mark.parametrize("gelu_approx", [True, False])
def test_block(gelu_approx):
    x = np.random.default_rng(3).standard_normal((2, 37, 128)).astype(np.float32)
    jblk = JaxBlock(128, 2, gelu_approx=gelu_approx, **DEPLOYED)
    with interpret_pallas():
        variables = init_perturbed(jblk, 8, jnp.asarray(x))
        expect = np.asarray(jblk.apply(variables, jnp.asarray(x)))
    blk = load(Block(128, 2, gelu_approx=gelu_approx), variables)
    with torch.no_grad():
        np.testing.assert_allclose(n(blk(t(x))), expect, atol=ATOL, rtol=0)


def test_backbone_pieces():
    """embed, the last-2 block taps and the final norm (the LayerNorm
    kernel's path), with a pos grid interpolated from 4×4 to 6×6."""
    kw = dict(img_size=56, patch_size=14, embed_dim=128, depth=3, num_heads=2)
    x = np.random.default_rng(4).uniform(0, 1, (2, 84, 84, 3)).astype(np.float32)
    jvit = JaxViT(gelu_approx=True, **DEPLOYED, **kw)

    def pieces(m, x):
        tokens, _ = m.embed(x, with_pos_cls=True)
        taps = m.collect_block_outputs(tokens, [1, 2])
        return taps, [m.final_norm(tp) for tp in taps]

    with interpret_pallas():
        variables = init_perturbed(jvit, 2, jnp.asarray(x))
        expect = jax.tree_util.tree_map(np.asarray,
                                        jvit.apply(variables, jnp.asarray(x), method=pieces))
    vit = load(DinoVisionTransformer(gelu_approx=True, **kw), variables)
    with torch.no_grad():
        got = pieces(vit, t(x))
    for e, g in zip(jax.tree_util.tree_leaves(expect),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(n, got))):
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=0)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def run():
    """Both models on the same seeded variables: eval logits on synthetic
    frames, and one train step (gradients of everything but the backbone)
    on a brightness-jittered batch."""
    ds = SyntheticSeg(n=2, imsize=IMG, seed=12)
    imgs, masks = next(ds.batches(2))
    x = (imgs / 255.0).astype(np.float32)
    rng = np.random.default_rng(22)
    xt = np.clip(x * rng.uniform(0.8, 1.2, (2, 1, 1, 1)), 0, 1).astype(np.float32)
    jmodel = JaxSegmentor(backbone=JaxViT(gelu_approx=True, **DEPLOYED, **VIT),
                          msda_impl="pallas", **HEAD)
    with interpret_pallas():
        variables = init_perturbed(jmodel, 17, jnp.asarray(x))
        logits = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
        params = dict(variables["params"])
        frozen = {"backbone": params.pop("backbone")}

        def loss_of(p, x, y):
            out, _ = jmodel.apply({"params": {**p, **frozen},
                                   "batch_stats": variables["batch_stats"]}, x,
                                  train=True, mutable=["batch_stats"])
            return LOSSES["dc"](jax.nn.softmax(out, axis=-1), y)

        jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params, jnp.asarray(xt),
                                                             jnp.asarray(masks))
    model = load(AdapterSegmentor(DinoVisionTransformer(gelu_approx=True, **VIT), **HEAD),
                 variables)
    out = eval_step(model, torch.from_numpy(imgs), torch.from_numpy(masks))
    trainer = Trainer(model, lr=0.05, epochs=4)
    loss = trainer.step(torch.from_numpy(xt), torch.from_numpy(masks).long(), 0)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return (logits, masks, out, float(jloss), _leaves(jgrads), float(loss),
            _leaves(state_dict_to_flax(grads)["params"]))


def test_logits_match(run):
    logits, _, out, *_ = run
    assert out["logits"].shape == (2, IMG, IMG, 2)
    # fp32 through 5 blocks, 4 adapter rounds and the decoder (as in
    # test_torch_segmentor): 1e-4 of the logit scale
    np.testing.assert_allclose(n(out["logits"]), logits, atol=1e-4 * np.abs(logits).max(),
                               rtol=0)


def test_eval_metrics_match(run):
    logits, masks, out, *_ = run
    per = [(jnp.asarray(logits[i:i + 1]), jnp.asarray(masks[i:i + 1])) for i in range(2)]
    loss = np.mean([float(weighted_ce_pair(l, m)) for l, m in per])
    dice = np.mean([1.0 - float(dc_loss(l, m)) for l, m in per])
    acc1 = np.mean([float(pixel_accuracy(l, m)) for l, m in per])
    assert abs(float(out["loss"]) - loss) < 1e-4 * max(1.0, abs(loss))
    assert abs(float(out["dice"]) - dice) < 1e-5
    # a pixel whose two logits tie within the tolerance above may flip
    assert abs(float(out["acc1"]) - acc1) <= 4 / (IMG * IMG)


def test_train_step_loss_and_gradients_match(run):
    *_, jloss, jgrads, loss, grads = run
    assert abs(loss - jloss) < 1e-5, (loss, jloss)
    assert set(grads) == set(jgrads)
    top = max(np.abs(g).max() for g in jgrads.values())
    for path, g in jgrads.items():
        # as test_torch_train_step: 1e-3 of each leaf's largest gradient, a
        # gradient that vanishes analytically held to 1e-6 of the largest
        scale = max(np.abs(g).max(), 1e-3 * top)
        np.testing.assert_allclose(grads[path], g, atol=1e-3 * scale, rtol=0, err_msg=path)
