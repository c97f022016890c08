"""The runner that holds a segmentor of the port against the JAX package's
on one seeded batch: the models at vit_test width (embed 64, 4 heads,
depth 5) on 56 px frames, their logits, a train step's loss, BatchNorm
statistics and gradients (`run`), and the checks with their tolerances.
Used by test_torch_tap_segmentor.py and test_torch_adapter_decoders.py."""

import copy
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.losses import LOSSES
from adaptersis_tpu.models.segmentor import AdapterSegmentor as JaxSegmentor
from adaptersis_tpu.models.tap_segmentor import TapSegmentor as JaxTapSegmentor
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu_torch.data.synthetic import SyntheticSeg
from adaptersis_tpu_torch.evaluate import model_loss
from adaptersis_tpu_torch.models.layers import TRAINED
from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.tap_segmentor import TapSegmentor
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import state_dict_to_flax
from adaptersis_tpu_torch.train.trainer import Trainer
from torch_parity import init_perturbed, interpret_library_flash, load, n

IMG = 56
VIT = dict(img_size=56, patch_size=14, embed_dim=64, depth=5, num_heads=4)
# the JAX backbone: plain XLA for the frozen walks (the deployed Pallas
# kernels' parity with the port's is held in test_torch_deployed.py; in
# interpret mode they triple these tests' compile time), the library flash
# attention for the trained one (K7's reference, in interpret mode)
TRAINED_JAX = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
ADAPTER = dict(num_classes=2, n_last_blocks=4, encoder_inplanes=16)


def leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def batch():
    """Seeded uniform noise frames in [0, 1] and synthetic masks. Not the
    synthetic frames themselves: their flat regions make many channels of
    the full-image UNet nearly constant over the batch, and the fp32
    gradients through those channels' training-mode BatchNorms lose up to
    3 % of a leaf's scale against a float64 step, on either side."""
    _, masks = next(SyntheticSeg(n=2, imsize=IMG, seed=3).batches(2))
    x = np.random.default_rng(4).integers(0, 256, (2, IMG, IMG, 3)) / 255.0
    return x.astype(np.float32), masks.astype(np.int32)


def models(model: str, flags: dict):
    """The JAX package's model and the port's, unloaded: `model` is a
    `--model` choice, `flags` the adapter model's."""
    ete = model == "tap_setr_ete"
    jvit = JaxViT(gelu_approx=True, **(TRAINED_JAX if ete else {}), **VIT)
    tvit = DinoVisionTransformer(gelu_approx=True, **VIT,
                                 **(TRAINED_JAX if ete else {}))
    if model == "adapter":
        return (JaxSegmentor(backbone=jvit, msda_impl="gather", **ADAPTER, **flags),
                AdapterSegmentor(tvit, **ADAPTER, **flags))
    tap = model[len("tap_"):]
    return (JaxTapSegmentor(backbone=jvit, num_classes=2, decoder=tap, train_backbone=ete),
            TapSegmentor(tvit, num_classes=2, decoder=tap))


def jax_run(jmodel, variables, x, y, value_loss, grad_loss, frozen_backbone: bool):
    """One jit: the eval-mode logits, the train-mode `value_loss` and new
    BatchNorm statistics, and the gradients of `grad_loss`."""
    params = dict(variables["params"])
    frozen = {"backbone": params.pop("backbone")} if frozen_backbone else {}
    batch_stats = variables.get("batch_stats", {})

    def loss_of(p):
        out, mut = jmodel.apply({"params": {**p, **frozen}, "batch_stats": batch_stats},
                                x, train=True, mutable=["batch_stats"])
        return grad_loss(out, y), (value_loss(out, y), mut.get("batch_stats", {}))

    @jax.jit
    def step(p):
        logits = jmodel.apply({"params": {**p, **frozen}, "batch_stats": batch_stats}, x)
        (_, (loss, stats)), g = jax.value_and_grad(loss_of, has_aux=True)(p)
        return logits, loss, stats, g

    logits, loss, stats, g = step(params)
    return np.asarray(logits, np.float32), float(loss), leaves(stats), leaves(g)


def torch_step(tmodel, x, y, loss, softmax):
    """The port's train step: its loss and its gradients per flax path."""
    trainer = Trainer(tmodel, lr=0.05, epochs=4, loss=loss, softmax=softmax)
    tloss = float(trainer.step(x, y, 0))
    grads = {name: p.grad for name, p in tmodel.named_parameters() if p.grad is not None}
    return tloss, leaves(state_dict_to_flax(grads)["params"])


@functools.lru_cache(maxsize=None)
def run(model: str, flags: tuple = ()):
    """`model` a `--model` choice, `flags` the adapter model's as (name,
    value) pairs. From the same seeded variables: the port's fp32 logits (eval mode)
    and fp32 train step's loss (the entry point's) and new BatchNorm
    statistics, against the JAX package's in float64 (its modules with
    dtype float64: the exact values, to fp32's tolerances); and both
    packages' gradients in float64 on the "dc" loss (after the trainer's
    softmax for the adapter model), which both compute in the input's
    dtype. In fp32 both packages' gradients differ from a float64 step's by
    up to 3 % of a leaf's scale at this size (the UNets' deepest BatchNorms
    see 2 to 18 values a channel, and fp32 roundings grow that far through
    them), so the backward passes are compared where rounding does not
    hide them. tap_setr_ete runs in fp32 on both sides, on its own loss:
    the library flash attention runs fp32 only."""
    flags = dict(flags)
    x, y = batch()
    softmax = model == "adapter"
    ete = model == "tap_setr_ete"
    loss_name = model_loss(model, "dc")
    jmodel, tmodel = models(model, flags)

    def jax_loss(name, out, labels):
        return LOSSES[name](jax.nn.softmax(out, axis=-1) if softmax else out, labels)

    value_loss = functools.partial(jax_loss, loss_name)
    with interpret_library_flash(), jax.enable_x64(not ete):
        variables = init_perturbed(jmodel, 17, jnp.asarray(x))
        dtype = jnp.float32 if ete else jnp.float64
        jmodel = jmodel.clone(dtype=dtype, backbone=jmodel.backbone.clone(dtype=dtype))
        logits, loss, stats, jgrads = jax_run(
            jmodel, variables, jnp.asarray(x, dtype), jnp.asarray(y), value_loss,
            value_loss if ete else functools.partial(jax_loss, "dc"), not ete)
    tmodel = load(tmodel, variables)
    t64 = copy.deepcopy(tmodel).double()
    with torch.no_grad():
        tlogits = n(tmodel(torch.from_numpy(x)))
    tloss, tgrads = torch_step(tmodel, torch.from_numpy(x), torch.from_numpy(y).long(),
                                loss_name, softmax)
    if not ete:
        _, tgrads = torch_step(t64, torch.from_numpy(x).double(), torch.from_numpy(y).long(),
                                "dc", softmax)
    return dict(logits=(logits, tlogits), loss=(loss, tloss), grads=(jgrads, tgrads),
                stats=(stats, leaves(state_dict_to_flax(tmodel)["batch_stats"])))


def check_logits(r) -> None:
    want, got = r["logits"]
    assert got.shape == want.shape == (2, IMG, IMG, 2)
    # as test_torch_segmentor: ~1e-4 of the logit scale, fp32 through the
    # walks, the adapters or the heads, with flax's E[x²] − E[x]² variances
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def check_loss_and_stats(r, has_batch_norm: bool = True) -> None:
    (jl, tl), (js, ts) = r["loss"], r["stats"]
    assert abs(tl - jl) < 1e-5 * max(1.0, abs(jl)), (tl, jl)
    assert set(ts) == set(js) and bool(js) == has_batch_norm
    for path, s in js.items():
        np.testing.assert_allclose(ts[path], s, atol=1e-5 * max(1.0, np.abs(s).max()),
                                   rtol=0, err_msg=path)


def check_gradients(r) -> None:
    """Per flax path, within the tolerance of test_torch_train_step: 1e-3 of
    each leaf's largest gradient (at least 1e-3 of the step's largest); a
    leaf whose JAX gradient is zero (the encoder's c1 projection, which no
    decoder reads; the trained backbone's unused mask token) is zero here
    too."""
    jg, tg = r["grads"]
    assert set(tg) == set(jg)
    top = max(np.abs(g).max() for g in jg.values())
    for path, g in jg.items():
        if not g.any():
            assert not tg[path].any(), path
            continue
        scale = max(np.abs(g).max(), 1e-3 * top)
        np.testing.assert_allclose(tg[path], g, atol=1e-3 * scale, rtol=0, err_msg=path)
