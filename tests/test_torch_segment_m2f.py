"""`adaptersis_tpu_torch.segment_m2f` against the JAX package's
`segment_m2f.py` train step at vit_test width (112 px, 10 queries, 32
channels, 2 decoder layers), from the same seeded variables and the same
random points (the JAX step's key): the loss (fp32 and float64), the new
BatchNorm statistics, and per subtree (adapter, pixel decoder, decoder
layers, prediction heads) every gradient, in float64 on both sides
(BatchNorm is on the path); on the JAX gradients also the behaviour the
port's trainer follows (zero injector gradients; AdamW's decay of them)
or leaves on purpose (the decay of the frozen backbone). Then the entry
points on the CPU: two epochs and a rerun that resumes, `bench_m2f`, and
the exit without a card."""

import functools
import json
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from adaptersis_tpu.models.m2f_loss import m2f_total_loss, semantic_to_instances
from adaptersis_tpu.models.mask2former import Mask2FormerHead as JaxHead
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu.models.vit_adapter import ViTAdapter as JaxViTAdapter
from adaptersis_tpu_torch import bench_m2f, segment_m2f
from adaptersis_tpu_torch.data.synthetic import SyntheticSeg
from adaptersis_tpu_torch.models.mask2former import Mask2FormerSegmentor
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import m2f_variables, state_dict_to_flax
from torch_parity import (load, m2f_total_draws, perturb, single_thread,  # noqa: F401
                          with_backbone_norm)

pytestmark = pytest.mark.usefixtures("single_thread")

IMG, B, NC, Q, C, LAYERS = 112, 2, 2, 10, 32, 2
VIT = dict(img_size=56, patch_size=14, embed_dim=64, depth=5, num_heads=4)   # vit_test
SUBTREES = {"adapter": lambda p: p[0] == "adapter",
            "pixel decoder": lambda p: p[:2] == ("head", "pixel_decoder"),
            "decoder layers": lambda p: p[0] == "head" and p[1].startswith("dec_"),
            "prediction heads": lambda p: p[0] == "head" and not p[1].startswith("dec_")
            and p[1] != "pixel_decoder"}


def _leaves(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch():
    """Seeded noise frames (their BatchNorm statistics are not degenerate)
    and synthetic masks."""
    _, masks = next(SyntheticSeg(n=B, imsize=IMG, seed=3).batches(B))
    imgs = np.random.default_rng(4).integers(0, 256, (B, IMG, IMG, 3)).astype(np.uint8)
    return imgs, masks.astype(np.int32)


def _jax_model(dtype):
    class Model(nn.Module):
        backbone: object

        @nn.compact
        def __call__(self, x, train: bool = False):
            feats = JaxViTAdapter(backbone=self.backbone, freeze_vit=True, msda_impl="gather",
                                  dtype=dtype, name="adapter")(x, train=train)
            return JaxHead(num_classes=NC, num_queries=Q, feat_channels=C,
                           num_decoder_layers=LAYERS, msda_impl="gather", dtype=dtype,
                           name="head")(feats, train=train)

    return Model(backbone=JaxViT(dtype=dtype, **VIT))


@functools.lru_cache(maxsize=None)
def jax_step():
    """segment_m2f.py's train_step (its device LAPJV, the TPU path: the
    pairs in gt-slot order) in float64: the variables, the loss, the new
    batch statistics, the gradients, and AdamW's updates."""
    imgs, masks = _batch()
    key = jax.random.PRNGKey(5)
    with jax.enable_x64():
        model = _jax_model(jnp.float64)
        x = jnp.asarray(imgs, jnp.float64) / 255.0
        variables = perturb(jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0), x, train=False)), 6)
        params, bs = variables["params"], variables["batch_stats"]
        gt_masks, gt_labels = jax.vmap(lambda m: semantic_to_instances(m, NC, NC))(
            jnp.asarray(masks))

        def loss_fn(p):
            (cls_all, mask_all), mut = model.apply({"params": p, "batch_stats": bs}, x,
                                                   train=True, mutable=["batch_stats"])
            total, _ = m2f_total_loss(cls_all, mask_all, gt_masks, gt_labels, key)
            return total, mut["batch_stats"]

        (loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        tx = optax.adamw(1e-4, weight_decay=0.05)
        updates, _ = tx.update(grads, tx.init(params), params)
        draws = m2f_total_draws(key, LAYERS + 1, B, NC)
        return (variables, float(loss), _leaves(new_bs), _leaves(grads), _leaves(updates),
                draws)


def _port_model(variables):
    model = Mask2FormerSegmentor(DinoVisionTransformer(**VIT), NC, Q, C, LAYERS)
    params = m2f_variables(dict(variables["params"]))
    params["adapter"] = with_backbone_norm(params["adapter"], VIT["embed_dim"])
    return load(model, {"params": params, "batch_stats": variables["batch_stats"]})


def _port_step(dtype):
    variables, _, _, _, _, draws = jax_step()
    model = _port_model(variables).to(dtype)
    trainer = segment_m2f.M2FTrainer(model, NC)
    imgs, masks = _batch()
    x = torch.from_numpy(imgs).to(dtype) / 255.0
    loss, _ = trainer.loss(x, torch.from_numpy(masks), {k: v.to(dtype) for k, v in
                                                        draws.items()})
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    flat = state_dict_to_flax(grads)["params"]
    return float(loss.detach()), _leaves(flat), _leaves(state_dict_to_flax(model)["batch_stats"])


def test_train_step_loss_and_batch_stats(monkeypatch):
    monkeypatch.setenv("ASN_M2F_DEVICE_HUNGARIAN", "1")
    _, want, want_bs, _, _, _ = jax_step()
    loss64, _, bs64 = _port_step(torch.float64)
    loss32, _, _ = _port_step(torch.float32)
    # float64, but the port rounds MSDA's sampling locations to fp32
    assert abs(loss64 - want) <= 1e-7 * abs(want), (loss64, want)
    # the entry point's fp32 step against the exact value
    assert abs(loss32 - want) <= 1e-5 * abs(want), (loss32, want)
    for path, s in want_bs.items():
        path = ("adapter", "backbone") + path[1:] if path[0] == "backbone" else path
        np.testing.assert_allclose(bs64[path], s, atol=1e-6 * max(1.0, np.abs(s).max()),
                                   rtol=0, err_msg=str(path))


@pytest.mark.parametrize("subtree", list(SUBTREES))
def test_train_step_gradients(subtree, monkeypatch):
    """Every leaf within 1e-5 of its own largest gradient plus 1e-6 of the
    subtree's: float64 on both sides, but the port rounds MSDA's sampling
    locations to fp32 (`MSDeformAttn`), noise that spreads over the whole
    subtree (≈ 1e-7 of its largest gradient measured; a leaf whose
    gradient vanishes analytically, a key bias or a bias before a
    training-mode BatchNorm, holds that noise alone). A leaf with no
    gradient in the port (the injectors) has a zero one in the JAX step."""
    monkeypatch.setenv("ASN_M2F_DEVICE_HUNGARIAN", "1")
    _, _, _, want, _, _ = jax_step()
    _, got, _ = _port_step(torch.float64)
    mine = {p: g for p, g in want.items() if SUBTREES[subtree](p)}
    assert mine
    top = max(np.abs(g).max() for g in mine.values())
    assert top > 0
    for path, g in mine.items():
        if path not in got:
            assert not g.any(), path
            continue
        np.testing.assert_allclose(got[path], g, atol=1e-5 * np.abs(g).max() + 1e-6 * top,
                                   rtol=0, err_msg=str(path))


def test_jax_step_zeroes_the_injectors_and_decays_the_frozen_backbone(monkeypatch):
    """On the JAX step: with freeze_vit the injectors' and the backbone's
    gradients are zero, the extractors' are not, and optax.adamw still
    moves every leaf, the backbone's and the injectors' by the weight decay
    alone (−lr·wd·p). The port gives the injectors zero gradients and so
    the same decay, and leaves the frozen backbone untouched (ROADMAP.md,
    "Found in the JAX package")."""
    monkeypatch.setenv("ASN_M2F_DEVICE_HUNGARIAN", "1")
    variables, _, _, grads, updates, _ = jax_step()
    params = _leaves(variables["params"])
    for path, g in grads.items():
        if path[0] == "backbone" or "injector" in path[1]:
            assert not g.any(), path
            # in the parameters' fp32
            np.testing.assert_allclose(updates[path], -1e-4 * 0.05 * params[path], rtol=1e-6,
                                       atol=0, err_msg=str(path))
    assert any(g.any() for p, g in grads.items() if "extractor" in p[1])
    # the port: the injectors take AdamW's decay, the backbone nothing
    model = _port_model(variables)
    trainer = segment_m2f.M2FTrainer(model, NC)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    imgs, masks = _batch()
    gen = torch.Generator().manual_seed(0)
    trainer.step(torch.from_numpy(imgs), torch.from_numpy(masks), trainer.draws(gen, B))
    for name, p in model.named_parameters():
        if name.startswith("adapter.backbone."):
            assert torch.equal(p, before[name]), name
        elif "injector" in name:
            torch.testing.assert_close(p, before[name] * (1 - 1e-4 * 0.05), rtol=1e-6,
                                       atol=0)


TINY = ["--device", "cpu", "--arch", "vit_test", "--imsize", "56", "--synthetic",
        "--batch_size_per_gpu", "2", "--num_queries", "8", "--feat_channels", "32",
        "--num_decoder_layers", "2", "--num_workers", "1"]


def test_cli_two_epochs_then_a_rerun_resumes(tmp_path):
    """Two epochs in one run; one epoch then a rerun of the same command
    with --epochs 2 resumes at epoch 1 and gives the same second epoch."""
    full = segment_m2f.main(TINY + ["--epochs", "2", "--output_dir", str(tmp_path / "a")])
    assert [h["epoch"] for h in full] == [0, 1]
    assert (tmp_path / "a" / "m2f_checkpoint.pth").exists()
    lines = [json.loads(x) for x in (tmp_path / "a" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1]
    for key in ("train_loss", "train_loss_cls", "train_loss_mask", "train_loss_dice",
                "val_dice", "val_acc1"):
        assert all(math.isfinite(x[key]) for x in lines), key
    segment_m2f.main(TINY + ["--epochs", "1", "--output_dir", str(tmp_path / "r")])
    resumed = segment_m2f.main(TINY + ["--epochs", "2", "--output_dir", str(tmp_path / "r")])
    assert [h["epoch"] for h in resumed] == [1]
    np.testing.assert_allclose(resumed[0]["train_losses"], full[1]["train_losses"],
                               rtol=1e-5, atol=0)
    again = segment_m2f.main(TINY + ["--epochs", "2", "--output_dir", str(tmp_path / "r")])
    assert again == []                      # a finished run trains nothing more


def test_bench_m2f_cpu_line_and_windowed_backbone(capsys):
    for arch in ("vit_test", "vit_small_windowed"):
        res = bench_m2f.main(["--device", "cpu", "--arch", arch, "--imsize", "56", "--batch",
                              "2", "--steps", "1", "--repeats", "1"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line == res
        assert {"metric", "value", "unit", "ms_step", "batch", "spread", "msda_impl",
                "device"} <= set(line)
        assert math.isfinite(line["value"]) and math.isfinite(line["loss"])


def test_entry_points_exit_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main, argv in ((segment_m2f.main, []), (bench_m2f.main, [])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
