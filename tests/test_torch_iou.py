"""The port's IoU losses and the EndoVis challenge metrics against the JAX
package's `losses/iou_multi.py` (with their empty-map rules), the 8-class
eval step against the JAX trainer's (`ch_iou`, `isi_iou`), a `--loss
iou_multi` train step against the JAX loss and gradients, and
`parity_frozen_head` (decoder-only gradients) against the JAX segmentor's.
Narrow models (embed 128, 2 heads, depth 5) at 56 px, fp32, the JAX
package's default attention and MSDA paths."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.losses import LOSSES as JAX_LOSSES
from adaptersis_tpu.losses import ch_iou as jax_ch_iou
from adaptersis_tpu.losses import iou_loss as jax_iou_loss
from adaptersis_tpu.losses import isi_iou as jax_isi_iou
from adaptersis_tpu.models.segmentor import AdapterSegmentor as JaxSegmentor
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu.parallel.mesh import get_mesh
from adaptersis_tpu.train.trainer import Trainer as JaxTrainer, TrainerConfig
from adaptersis_tpu_torch.losses import LOSSES, ch_iou, get_loss, iou_loss, isi_iou
from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import state_dict_to_flax
from adaptersis_tpu_torch.train.trainer import Trainer, eval_step
from torch_parity import init_perturbed, load, n

IMG = 56
VIT = dict(img_size=56, patch_size=14, embed_dim=128, depth=5, num_heads=2)
HEAD = dict(n_last_blocks=4, encoder_inplanes=16, decoder_features=(128, 32, 16, 16, 8))


def _labels(seed, shape=(4, 24, 24), C=8):
    """Label maps with a few classes each, one image all background."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.uniform(size=shape) < 0.5, 0, rng.integers(1, C, shape)).astype(np.int32)
    y[0] = 0
    return y


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((4, 24, 24, 8)).astype(np.float32)
    y = _labels(seed)
    want = float(jax_iou_loss(jnp.asarray(logits), jnp.asarray(y)))
    got = float(iou_loss(torch.from_numpy(logits), torch.from_numpy(y)))
    # fp32 softmax and sums over 576 pixels in other orders
    assert abs(got - want) < 1e-6, (got, want)
    assert LOSSES["iou_multi"] is iou_loss


def test_challenge_metrics_match_jax_with_empty_maps():
    rng = np.random.default_rng(3)
    y = _labels(3)
    p = _labels(4)
    cases = [(y[i], p[i]) for i in range(1, 4)]
    empty = np.zeros_like(y[0])
    cases += [(empty, empty),                 # both empty: 1
              (empty, p[1]),                  # only the prediction has foreground: 0
              (y[1], empty),                  # empty prediction: IoU 0 per present class
              (y[1], y[1]),                   # exact: 1
              (np.where(rng.uniform(size=y[0].shape) < 0.1, 7, 0).astype(np.int32), y[2])]
    for t, q in cases:
        for mine, ref in ((ch_iou(torch.from_numpy(t), torch.from_numpy(q)),
                           jax_ch_iou(jnp.asarray(t), jnp.asarray(q))),
                          (isi_iou(torch.from_numpy(t), torch.from_numpy(q)),
                           jax_isi_iou(jnp.asarray(t), jnp.asarray(q)))):
            # the same fp32 ratios, averaged in the same order
            assert abs(float(mine) - float(ref)) < 1e-6, (float(mine), float(ref))
    assert float(ch_iou(torch.from_numpy(empty), torch.from_numpy(empty))) == 1.0
    assert float(isi_iou(torch.from_numpy(empty), torch.from_numpy(p[1]))) == 0.0


def test_unported_losses_exit_naming_the_item():
    assert get_loss("dc") is LOSSES["dc"]
    assert set(LOSSES) < set(JAX_LOSSES)
    for name in set(JAX_LOSSES) - set(LOSSES):
        with pytest.raises(SystemExit, match="M11"):
            get_loss(name)
    with pytest.raises(SystemExit, match="unknown"):
        get_loss("no_such_loss")


@pytest.fixture(scope="module")
def eight_class():
    """The same seeded 8-class model in both packages, a batch of 4 frames."""
    jmodel = JaxSegmentor(backbone=JaxViT(**VIT), num_classes=8, **HEAD)
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (4, IMG, IMG, 3)).astype(np.uint8)
    masks = _labels(8, (4, IMG, IMG))
    variables = init_perturbed(jmodel, 17, jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    model = load(AdapterSegmentor(DinoVisionTransformer(**VIT), num_classes=8, **HEAD),
                 variables)
    return jmodel, variables, model, imgs, masks


def test_eight_class_eval_step_reports_challenge_metrics(eight_class):
    jmodel, variables, model, imgs, masks = eight_class
    params = dict(variables["params"])
    state = {"params": params, "frozen": {"backbone": params.pop("backbone")},
             "batch_stats": variables["batch_stats"]}
    jtrainer = JaxTrainer(jmodel, TrainerConfig(), mesh=get_mesh(jax.devices()[:1]))
    valid = np.array([True, True, True, False])
    jm, jpreds = jtrainer.eval_step(state, imgs, masks, valid)
    out = eval_step(model, torch.from_numpy(imgs), torch.from_numpy(masks),
                    torch.from_numpy(valid))
    assert {"loss", "dice", "acc1", "ch_iou", "isi_iou"} <= set(out)
    preds = n(out["preds"]).astype(np.int64)
    # a pixel whose top two logits tie within the logits' fp32 agreement
    # (1e-4 of their scale, test_torch_segmentor) may take the other class
    flipped = (preds != np.asarray(jpreds))[valid].mean()
    assert flipped <= 4 / (IMG * IMG)
    # on the same predictions the metrics agree to fp32 rounding ...
    same = [jax_ch_iou(jnp.asarray(masks[i]), jnp.asarray(preds[i]), num_classes=8)
            for i in range(3)]
    assert abs(float(out["ch_iou"]) - float(np.mean(same))) < 1e-6
    same = [jax_isi_iou(jnp.asarray(masks[i]), jnp.asarray(preds[i])) for i in range(3)]
    assert abs(float(out["isi_iou"]) - float(np.mean(same))) < 1e-6
    # ... and against the JAX trainer's own: a flipped pixel moves one class's
    # IoU of one image by ≤ 1/|∪| (|∪| ≥ 1 pixel; here ≥ 100)
    for k in ("ch_iou", "isi_iou"):
        assert abs(float(out[k]) - float(jm[k])) <= 1e-2 * flipped * IMG * IMG + 1e-6, k
    for k in ("dice", "acc1"):
        assert abs(float(out[k]) - float(jm[k])) < 1e-3, k


def _grads_both(variables, jmodel, model, x, y, loss_name):
    params = dict(variables["params"])
    frozen = {"backbone": params.pop("backbone")}
    loss_fn = JAX_LOSSES[loss_name]

    def loss_of(p):
        logits, _ = jmodel.apply({"params": {**p, **frozen},
                                  "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(x), train=True, mutable=["batch_stats"])
        return loss_fn(jax.nn.softmax(logits, axis=-1), jnp.asarray(y))

    jl, jg = jax.jit(jax.value_and_grad(loss_of))(params)
    trainer = Trainer(model, lr=0.0, epochs=4, loss=loss_name)
    tl = trainer.step(torch.from_numpy(x), torch.from_numpy(y).long(), 0)
    tg = {name: p.grad for name, p in model.named_parameters() if p.grad is not None}
    return float(jl), _leaves(jg), float(tl), _leaves(state_dict_to_flax(tg)["params"])


def test_iou_multi_train_step_matches_jax(eight_class):
    jmodel, variables, _, imgs, masks = eight_class
    model = load(AdapterSegmentor(DinoVisionTransformer(**VIT), num_classes=8, **HEAD),
                 variables)
    x = (imgs / 255.0).astype(np.float32)
    jl, jg, tl, tg = _grads_both(variables, jmodel, model, x, masks, "iou_multi")
    # fp32 through the whole model (test_torch_train_step)
    assert abs(tl - jl) < 1e-5, (tl, jl)
    top = max(np.abs(g).max() for g in jg.values())
    for path, g in jg.items():
        # 1e-3 of each leaf's largest gradient, as the DC train step is held
        scale = max(np.abs(g).max(), 1e-3 * top)
        np.testing.assert_allclose(tg[path], g, atol=1e-3 * scale, rtol=0, err_msg=path)


def test_parity_frozen_head_trains_the_decoder_only():
    jmodel = JaxSegmentor(backbone=JaxViT(**VIT), num_classes=2, parity_frozen_head=True,
                          **HEAD)
    variables = init_perturbed(jmodel, 19, jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    model = load(AdapterSegmentor(DinoVisionTransformer(**VIT), num_classes=2,
                                  parity_frozen_head=True, **HEAD), variables)
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(2, IMG, IMG, 3)).astype(np.float32)
    y = (rng.uniform(size=(2, IMG, IMG)) < 0.3).astype(np.int32)
    jl, jg, tl, tg = _grads_both(variables, jmodel, model, x, y, "dc")
    assert abs(tl - jl) < 1e-5, (tl, jl)
    decoder = [k for k in jg if k.startswith("decoder/")]
    assert decoder and set(decoder) <= set(tg)
    top = max(np.abs(jg[k]).max() for k in decoder)
    for path in decoder:
        scale = max(np.abs(jg[path]).max(), 1e-3 * top)
        np.testing.assert_allclose(tg[path], jg[path], atol=1e-3 * scale, rtol=0,
                                   err_msg=path)
    for path, g in jg.items():
        if not path.startswith("decoder/"):
            assert not g.any(), path
            assert not tg[path].any(), path       # the trainer's zero gradient
    for name, p in model.named_parameters():
        if not name.startswith(("backbone.", "decoder.")):
            assert p.grad is not None and not p.grad.any(), name
