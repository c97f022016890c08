"""The port's training step against the JAX package's, on a narrow model
(embed 128, 2 heads of 64, depth 5, 112 px, fp32) with JAX's flash_fwd and
msda "pallas" kernels in interpret mode: given the same augmented batches,
the loss, every trainable's gradient per flax path, the new BatchNorm
statistics and the parameters after two SGD steps match `model.apply(...,
train=True, mutable=["batch_stats"])` → softmax → `LOSSES["dc"]` →
`jax.value_and_grad` → `Trainer.tx` with `cosine_annealing`. Also the
entry point `train_seg` on the CPU, its refusal without a GPU, the flax
variable bridge in both directions, and the port's sampler and schedule."""

import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.data.samplers import EpochSampler as JaxEpochSampler
from adaptersis_tpu.losses import LOSSES
from adaptersis_tpu.models.segmentor import AdapterSegmentor as JaxSegmentor
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu.train.schedules import cosine_annealing as jax_cosine
from adaptersis_tpu.train.trainer import Trainer as JaxTrainer, TrainerConfig
from adaptersis_tpu_torch import train_seg
from adaptersis_tpu_torch.data.samplers import EpochSampler
from adaptersis_tpu_torch.data.synthetic import SyntheticSeg
from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import (
    load_flax_variables, seeded_init_, state_dict_to_flax)
from adaptersis_tpu_torch.train.schedules import cosine_annealing
from adaptersis_tpu_torch.train.trainer import Trainer
from torch_parity import init_perturbed, interpret_pallas, load, n

IMG = 112
VIT = dict(img_size=56, patch_size=14, embed_dim=128, depth=5, num_heads=2)
HEAD = dict(num_classes=2, n_last_blocks=4, encoder_inplanes=16,
            decoder_features=(128, 32, 16, 16, 8))
LR, EPOCHS = 0.05, 4


def _batches():
    """Two 'augmented' batches: synthetic frames with a seeded brightness
    jitter, in [0, 1], and their masks."""
    rng = np.random.default_rng(21)
    out = []
    for seed in (3, 4):
        ds = SyntheticSeg(n=2, imsize=IMG, seed=seed)
        imgs, masks = next(ds.batches(2))
        x = np.clip(imgs / 255.0 * rng.uniform(0.8, 1.2, (2, 1, 1, 1)), 0, 1)
        out.append((x.astype(np.float32), masks.astype(np.int32)))
    return out


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def run():
    batches = _batches()
    with interpret_pallas():
        jmodel = JaxSegmentor(backbone=JaxViT(attn_impl="flash_fwd", gelu_approx=True, **VIT),
                              msda_impl="pallas", **HEAD)
        variables = init_perturbed(jmodel, 13, jnp.asarray(batches[0][0]))
        params = dict(variables["params"])
        frozen = {"backbone": params.pop("backbone")}
        tx = JaxTrainer(jmodel, TrainerConfig(lr=LR, epochs=EPOCHS)).tx
        lr_fn = jax_cosine(LR, EPOCHS)

        def loss_of(p, stats, x, y):
            logits, mut = jmodel.apply({"params": {**p, **frozen}, "batch_stats": stats}, x,
                                       train=True, mutable=["batch_stats"])
            return LOSSES["dc"](jax.nn.softmax(logits, axis=-1), y), mut["batch_stats"]

        grad_fn = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
        p, stats, opt = params, variables["batch_stats"], tx.init(params)
        jax_steps = []
        for epoch, (x, y) in enumerate(batches):
            (loss, stats), grads = grad_fn(p, stats, jnp.asarray(x), jnp.asarray(y))
            updates, opt = tx.update(grads, opt, p)
            p = jax.tree_util.tree_map(lambda a, u: a + lr_fn(epoch) * u, p, updates)
            jax_steps.append((float(loss), _leaves(grads), _leaves(stats)))
        jax_params = _leaves(p)

    model = load(AdapterSegmentor(DinoVisionTransformer(gelu_approx=True, **VIT), **HEAD),
                 variables)
    trainer = Trainer(model, lr=LR, epochs=EPOCHS)
    torch_steps = []
    for epoch, (x, y) in enumerate(batches):
        loss = trainer.step(torch.from_numpy(x), torch.from_numpy(y).long(), epoch)
        grads = {name: p.grad for name, p in model.named_parameters() if p.grad is not None}
        flax = state_dict_to_flax(model)
        torch_steps.append((float(loss), _leaves(state_dict_to_flax(grads)["params"]),
                            _leaves(flax["batch_stats"])))
    params = {k: v for k, v in _leaves(state_dict_to_flax(model)["params"]).items()
              if not k.startswith("backbone/")}
    return jax_steps, torch_steps, jax_params, params, model


def test_loss_matches(run):
    jax_steps, torch_steps, *_ = run
    for (jl, *_), (tl, *_) in zip(jax_steps, torch_steps):
        # fp32 through the whole model on both sides (see test_torch_segmentor)
        assert abs(tl - jl) < 1e-5, (tl, jl)


def test_gradients_match_per_flax_path(run):
    """The first step's gradients, where both start from the same
    parameters. After one SGD step the two parameter sets differ by rounding,
    and a few bilinear sample points and ReLU inputs then sit within rounding
    of a kink (an integer pixel coordinate, zero), where the derivative
    jumps; the second step is held by its loss, its statistics and the
    parameters it produces."""
    jax_steps, torch_steps, *_ = run
    for (_, jg, _), (_, tg, _) in zip(jax_steps[:1], torch_steps[:1]):
        # the feature decoder reads no c1, so the encoder's c1 projection
        # gets an all-zero gradient on both sides
        unused = {"encoder/fc1/bias", "encoder/fc1/kernel"}
        assert set(tg) == set(jg)
        assert all(not jg[k].any() and not tg[k].any() for k in unused)
        top = max(np.abs(g).max() for g in jg.values())
        for path, g in ((k, v) for k, v in jg.items() if k not in unused):
            # fp32 forward and backward through 4 adapter rounds, the
            # decoder's BatchNorms and resizes: 1e-3 of each leaf's largest
            # gradient (the sums run in other orders, and flax takes the
            # LayerNorm and BatchNorm variance as E[x²] − E[x]²). A gradient
            # that vanishes analytically (a conv bias just before a
            # training-mode BatchNorm) is rounding noise on both sides:
            # it is held to 1e-6 of the step's largest gradient
            scale = max(np.abs(g).max(), 1e-3 * top)
            np.testing.assert_allclose(tg[path], g, atol=1e-3 * scale, rtol=0, err_msg=path)
            assert np.abs(tg[path]).max() > 0, f"{path} got no gradient"


def test_batch_stats_match(run):
    jax_steps, torch_steps, *_ = run
    for (_, _, js), (_, _, ts) in zip(jax_steps, torch_steps):
        assert set(ts) == set(js)
        for path, s in js.items():
            # flax's fast variance E[x²] − E[x]² against torch's two-pass
            # form: 1e-5 of the statistic's scale
            np.testing.assert_allclose(ts[path], s, atol=1e-5 * max(1.0, np.abs(s).max()),
                                       rtol=0, err_msg=path)


def test_parameters_after_two_sgd_steps(run):
    _, _, jax_params, params, _ = run
    assert set(params) == {k for k in jax_params if not k.startswith("backbone/")}
    for path, p in params.items():
        # two updates of lr·(momentum buffer) from the gradients above
        np.testing.assert_allclose(p, jax_params[path], atol=1e-5, rtol=1e-5, err_msg=path)
    for path in ("encoder/fc1/kernel", "encoder/fc1/bias"):
        # zero gradients: weight decay and momentum alone move the c1
        # projection, by ≈ 4.5e-6 of each value over two steps; both sides
        # compute the same fp32 products, so a few ulps (6e-8 each) apart
        np.testing.assert_allclose(params[path], jax_params[path], atol=0, rtol=5e-7,
                                   err_msg=path)


def test_frozen_backbone_gets_no_gradient(run):
    *_, model = run
    for name, p in model.backbone.named_parameters():
        assert not p.requires_grad and p.grad is None, name
    assert all(p.requires_grad for name, p in model.named_parameters()
               if not name.startswith("backbone."))


def test_state_dict_to_flax_round_trips():
    """flax → torch (load_flax_variables) → flax (state_dict_to_flax) is the
    identity on the JAX segmentor's variable tree, and torch → flax → torch
    on a seeded model."""
    jmodel = JaxSegmentor(backbone=JaxViT(**VIT), **HEAD)
    variables = init_perturbed(jmodel, 5, jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    model = load(AdapterSegmentor(DinoVisionTransformer(**VIT), **HEAD), variables)
    back = state_dict_to_flax(model)
    for tree in ("params", "batch_stats"):
        want, got = _leaves(variables[tree]), _leaves(back[tree])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    seeded = seeded_init_(AdapterSegmentor(DinoVisionTransformer(**VIT), **HEAD), 2)
    fresh = AdapterSegmentor(DinoVisionTransformer(**VIT), **HEAD)
    flax = state_dict_to_flax(seeded)
    load_flax_variables(fresh, flax["params"], flax["batch_stats"])
    for k, v in seeded.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_train_seg_runs_on_cpu(tmp_path):
    hist = train_seg.main(["--arch", "vit_test", "--patch_size", "14", "--imsize", "56",
                           "--batch_size_per_gpu", "2", "--epochs", "1", "--synthetic",
                           "--device", "cpu", "--output_dir", str(tmp_path)])
    stats = hist[0]
    assert len(stats["train_losses"]) == 8 and stats["train_losses_finite"]
    for k in ("train_loss", "test_loss", "test_dice", "test_acc1", "train_img_per_s"):
        assert np.isfinite(stats[k]), k
    logged = [json.loads(line) for line in (tmp_path / "log.txt").read_text().splitlines()]
    assert len(logged) == 1 and logged[0]["epoch"] == 0 and logged[0]["device"] == "cpu"
    with np.load(tmp_path / "variables.npz") as f:
        assert "params/level_embed" in f and "batch_stats/decoder/decoder_1/bn/var" in f


def test_train_seg_requires_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_seg.main(["--arch", "vit_test", "--patch_size", "14", "--imsize", "56",
                        "--synthetic", "--output_dir", str(tmp_path)])


@pytest.mark.parametrize("epoch", [0, 3])
def test_sampler_and_schedule_match_jax(epoch):
    mine, ref = EpochSampler(37, seed=5, rank=1, world_size=3), \
        JaxEpochSampler(37, seed=5, rank=1, world_size=3)
    mine.set_epoch(epoch)
    ref.set_epoch(epoch)
    assert list(mine) == list(ref) and len(mine) == len(ref)
    assert cosine_annealing(0.01, 7)(epoch) == pytest.approx(float(jax_cosine(0.01, 7)(epoch)),
                                                             rel=1e-12)


def _seeded_as_written(model, seed, skip=()):
    """`seeded_init_`'s draw written out tensor by tensor: each drawn anew,
    scaled and cast to fp32."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "num_batches_tracked" or name.startswith(skip):
                continue
            shape = tuple(t.shape)
            if leaf == "running_var":
                a = rng.uniform(0.5, 1.5, shape)
            elif leaf == "weight" and t.dim() >= 2:
                a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            elif leaf == "weight":
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            elif leaf in ("cls_token", "pos_embed", "mask_token"):
                a = 0.02 * rng.standard_normal(shape)
            else:
                a = 0.1 * rng.standard_normal(shape)
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


@pytest.mark.parametrize("skip", [(), ("backbone.",)])
def test_seeded_init_gives_the_bits_of_each_tensor_drawn_anew(skip):
    """The draw into one reused buffer, scaled in place, gives the same bits
    as drawing, scaling and casting each tensor anew (BatchNorm statistics,
    norm scales, tokens and biases among them), with and without a skipped
    backbone."""
    import copy
    base = AdapterSegmentor(DinoVisionTransformer(**VIT), **HEAD)
    got = seeded_init_(copy.deepcopy(base), 5, skip=skip).state_dict()
    want = _seeded_as_written(copy.deepcopy(base), 5, skip=skip).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _to_flax_as_written(state):
    """`state_dict_to_flax` written out in numpy: each tensor copied, then
    transposed and laid out contiguously by numpy."""
    from adaptersis_tpu_torch.train.convert import TRANSPOSED
    out = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        mod, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().float().cpu().numpy().copy()
        tree = "params"
        if leaf in ("running_mean", "running_var"):
            tree, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and a.ndim == 2:
            a, leaf = a.T, "kernel"
        elif leaf == "weight" and a.ndim == 4 and mod.rpartition(".")[2] in TRANSPOSED:
            a, leaf = a.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
        elif leaf == "weight" and a.ndim == 4:
            a, leaf = a.transpose(2, 3, 1, 0), "kernel"
        elif leaf == "weight":
            leaf = "scale"
        path = re.sub(r"(^|\.)blocks\.(\d+)(?=\.|$)", r"\1blocks_\2", mod)
        out[tree]["/".join(path.split(".") + [leaf]) if mod else leaf] = np.ascontiguousarray(a)
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("model", ["adapter", "tap_masktrans", "tap_setr_ete", "tap_unet"])
def test_state_dict_to_flax_gives_the_bits_of_numpy_transposes(model):
    """`state_dict_to_flax`, which transposes and lays out in torch, gives
    each array the bits, shape and C order of numpy's transposes (the
    adapter's and the UNet's transposed convolutions among them), and no
    array shares memory with the live tensor."""
    from adaptersis_tpu_torch import evaluate
    args = train_seg.get_args_parser().parse_args(
        ["--arch", "vit_test", "--patch_size", "14", "--model", model])
    state = evaluate.build_model(args).state_dict()
    got = state_dict_to_flax(state)
    want = _to_flax_as_written(state)
    for tree in ("params", "batch_stats"):
        mine, ref = dict(_flat(got[tree])), want[tree]
        assert set(mine) == set(ref)
        for k, v in ref.items():
            assert mine[k].dtype == v.dtype and mine[k].flags.c_contiguous, k
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
    for t in state.values():
        ptr = t.data_ptr()
        assert all(a.__array_interface__["data"][0] != ptr
                   for tree in got.values() for _, a in _flat(tree)), "a view"
