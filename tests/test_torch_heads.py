"""The port's decode heads (`models/heads.py`) against the JAX package's,
from the same seeded flax variables carried across by the weight bridge:
BNHead (DPTHead in test_torch_dpt_head.py) in eval mode (outputs) and in
train mode (outputs, the new BatchNorm statistics, the loss and every
gradient),
float64 on both sides (JAX modules with dtype float64 under x64): in fp32,
BatchNorm gradients over a few values a channel differ from float64 by up
to a few per cent on either side. Also sig_loss and gradient_loss, and
the bridge's transposed convolutions `up4` and `up2`, whose kernels have as
many input channels as outputs: converted as an ordinary convolution's
(the name missed) or without the spatial flip they load without a shape
error and give other outputs. DepthEncoderDecoder with the linear
(binned) head in eval and train mode; with the DPT head in
test_torch_depther.py."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from adaptersis_tpu.models import heads as jh
from adaptersis_tpu.models.depther import DepthEncoderDecoder as JaxDepther
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu_torch.models import heads as th
from adaptersis_tpu_torch.models.depther import DepthEncoderDecoder
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train import convert
from adaptersis_tpu_torch.train.convert import seeded_init_, state_dict_to_flax
from torch_parity import init_perturbed, load, n, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

B = 2


def flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float64)
    return out


def taps(C, hw=(3, 4), n_taps=4, seed=0, sizes=None):
    rng = np.random.default_rng(seed)
    sizes = sizes or [hw] * n_taps
    return [(rng.standard_normal((B, *s, C)), rng.standard_normal((B, C))) for s in sizes]


def as_jax(tp):
    return [(jnp.asarray(p), jnp.asarray(c)) for p, c in tp]


def as_torch(tp):
    return [(torch.from_numpy(p), torch.from_numpy(c)) for p, c in tp]


def run_both(jmod, tmod, j_in, t_in, j_loss, t_loss, param_filter="", eval_mode=True,
             variables=None):
    """From the same seeded variables, float64: (JAX, port) × (eval-mode
    output (None without `eval_mode`), train-mode output, its loss, the new
    batch statistics, the gradients of the params under `param_filter`).
    The variables are drawn for the JAX module and carried to the port by
    the weight bridge, or given: the port module's own (`state_dict_to_flax`
    of it, which saves tracing the JAX module's init). The JAX side is one
    jitted program."""
    from_port = variables is not None
    with jax.enable_x64(True):
        if not from_port:
            variables = init_perturbed(jmod, 5, *j_in(jnp.float32))
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jmod = jmod.clone(dtype=jnp.float64, **(
            {"backbone": jmod.backbone.clone(dtype=jnp.float64)} if hasattr(jmod, "backbone")
            else {}))
        stats = v64.get("batch_stats", {})

        def train(params, *inputs):
            out, upd = jmod.apply({"params": params, "batch_stats": stats}, *inputs,
                                  train=True, mutable=["batch_stats"])
            return j_loss(out), (out, upd["batch_stats"])

        @jax.jit
        def both(params, *inputs):
            (loss, (out, new)), grads = jax.value_and_grad(train, has_aux=True)(params, *inputs)
            ev = (jmod.apply({"params": params, "batch_stats": stats}, *inputs, train=False)
                  if eval_mode else None)
            return ev, out, loss, new, grads

        jev, jo, jl, js, jg = jax.device_get(both(v64["params"], *j_in(jnp.float64)))
        want = (None if jev is None else np.asarray(jev), np.asarray(jo), float(jl), flat(js),
                {k: v for k, v in flat(jg).items() if k.startswith(param_filter)})
    tmod = (tmod.eval() if from_port else load(tmod, variables)).double()
    ev = None
    if eval_mode:
        with torch.no_grad():
            ev = n(tmod(*t_in()))
    tmod.train()
    out = tmod(*t_in())
    loss = t_loss(out)
    loss.backward()
    grads = {k: p.grad for k, p in tmod.named_parameters() if p.grad is not None}
    got = (ev, n(out), loss.item(), flat(state_dict_to_flax(tmod)["batch_stats"]),
           flat(state_dict_to_flax(grads)["params"]))
    return want, got


def check(want, got, out_atol=1e-6, grad_atol=1e-5, stats_atol=1e-6, loss_rtol=1e-6):
    (jev, jo, jl, js, jg), (tev, to, tl, ts, tg) = want, got
    assert (tev is None) == (jev is None)
    for t_, j_ in ((tev, jev), (to, jo)) if jev is not None else ((to, jo),):
        assert t_.shape == j_.shape
        np.testing.assert_allclose(t_, j_, atol=out_atol * max(1.0, np.abs(j_).max()), rtol=0)
    if loss_rtol is not None:
        assert tl == pytest.approx(jl, rel=loss_rtol, abs=1e-9)
    assert set(ts) == set(js)
    for k, s in js.items():
        np.testing.assert_allclose(ts[k], s, atol=stats_atol * max(1.0, np.abs(s).max()),
                                   rtol=0, err_msg=k)
    assert set(tg) == set(jg) and jg
    top = max(np.abs(g).max() for g in jg.values())
    for k, g in jg.items():
        scale = max(np.abs(g).max(), 1e-3 * top)
        np.testing.assert_allclose(tg[k], g, atol=grad_atol * scale, rtol=0, err_msg=k)


def weighted_sum(shape, seed):
    """A loss Σ out·W with seeded W (a constant cotangent would let a
    wrong forward through)."""
    w = np.random.default_rng(seed).standard_normal(shape)
    return (lambda out: jnp.sum(out * jnp.asarray(w, out.dtype)),
            lambda out: (out * torch.from_numpy(w).to(out.dtype)).sum())


@pytest.mark.parametrize("case", ["cls", "no_cls", "resized"])
def test_bn_head(case):
    C, K = 8, 5
    sizes = [(3, 4), (6, 8), (3, 4), (2, 2)] if case == "resized" else None
    tp = taps(C, sizes=sizes, seed=1)
    use_cls = case != "no_cls"
    in_ch = 4 * C * (2 if use_cls else 1)
    jl, tl = weighted_sum((B, 3, 4, K), 2)
    want, got = run_both(
        jh.BNHead(num_classes=K, use_cls_token=use_cls), th.BNHead(in_ch, K, use_cls),
        lambda dt: [[(jnp.asarray(p, dt), jnp.asarray(c, dt)) for p, c in tp]],
        lambda: [as_torch(tp)], jl, tl)
    check(want, got)


VIT = dict(img_size=56, patch_size=14, embed_dim=32, depth=4, num_heads=2)


def depther_case(head: str):
    """From variables drawn for the port (`seeded_init_`, carried to JAX by
    the bridge's inverse): the depth map in eval mode (linear); in train
    mode the depth map, the head's BatchNorm statistics and its gradients
    of Σ depth·W, and `loss` (the scale-invariant + gradient loss) of each
    side's depth map. Both sides' heads read the JAX backbone's float64
    taps: the port's deployed ViT computes in fp32 whatever its dtype (its
    kernels' plain versions), and taps 1e-7 apart flip a few ReLUs of the
    256-channel DPT head and move their gradients discretely (the ViT is
    held against the JAX one in test_torch_vit.py). The JAX depther casts
    the linear head's logits and the resized depth to fp32, and the port
    does the same, so the maps and the gradients carry fp32 roundings on
    both sides."""
    rng = np.random.default_rng(6)
    # 1 × 2 patches: the DPT head's 256-channel convolutions (fixed in the
    # JAX depther) in float64 stay cheap; the ½× stage is 1 × 1, and
    # fusion_3's 2 × 2 output is resized to the 1 × 2 stage
    x = rng.uniform(0, 1, (B, 14, 28, 3))
    target = rng.uniform(0.5, 5.0, (B, 14, 28)).astype(np.float32)
    target[:, :2] = 0.0                                   # invalid pixels
    kw = dict(head=head, n_bins=16) if head == "linear" else dict(head=head)
    jmod = JaxDepther(backbone=JaxViT(**VIT), **kw)
    tmod = seeded_init_(DepthEncoderDecoder(DinoVisionTransformer(**VIT), **kw), 5)
    variables = state_dict_to_flax(tmod)
    with jax.enable_x64(True):
        jvit = JaxViT(**VIT, dtype=jnp.float64)
        jtaps = jax.jit(lambda p, x_: jvit.apply({"params": p}, x_, n=4, return_class_token=True,
                                                 method=jvit.get_intermediate_layers))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   variables["params"]["backbone"]), jnp.asarray(x))
        taps = tuple((torch.from_numpy(np.array(p)), torch.from_numpy(np.array(c)))
                     for p, c in jtaps)
    tmod.backbone.get_intermediate_layers = lambda *a, **k: taps
    jl, tl = weighted_sum((B, 14, 28, 1), 8)
    want, got = run_both(jmod, tmod, lambda dt: [jnp.asarray(x, dt)],
                         lambda: [torch.from_numpy(x)], jl, tl,
                         param_filter="decode_head", eval_mode=head == "linear",
                         variables=variables)
    assert got[1].shape == (B, 14, 28, 1) and got[1].dtype == np.float32
    assert not tmod.backbone.training
    # the weighted sum of an fp32 depth map (a sum of 784 terms that cancel)
    # adds nothing to the per-element bound on the map itself
    check(want, got, out_atol=1e-5, grad_atol=1e-4, stats_atol=1e-5, loss_rtol=None)
    j_loss = jax.jit(lambda p, t_: jh.sig_loss(p[..., 0], t_)
                     + 0.5 * jh.gradient_loss(p[..., 0], t_))
    assert float(tmod.loss(torch.from_numpy(got[1]), torch.from_numpy(target))) == \
        pytest.approx(float(j_loss(jnp.asarray(want[1], jnp.float32), jnp.asarray(target))),
                      rel=1e-5)


def test_depther_linear():
    depther_case("linear")


def test_depth_losses():
    rng = np.random.default_rng(7)
    target = rng.uniform(0.5, 5.0, (2, 16, 20)).astype(np.float32)
    target[0, :4] = 0.0
    pred = (target * rng.uniform(0.7, 1.4, target.shape)).astype(np.float32)
    valid = rng.uniform(size=target.shape) < 0.8
    for args in ((pred, target), (pred, target, valid)):
        want = float(jax.jit(jh.sig_loss)(*map(jnp.asarray, args)))
        got = float(th.sig_loss(*map(torch.from_numpy, args)))
        assert got == pytest.approx(want, rel=1e-5)
    for scales in (1, 4):
        want = float(jax.jit(jh.gradient_loss, static_argnums=2)(
            jnp.asarray(pred), jnp.asarray(target), scales))
        got = float(th.gradient_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                     scales=scales))
        assert got == pytest.approx(want, rel=1e-5)
    assert float(th.sig_loss(torch.from_numpy(target), torch.from_numpy(target))) < 1e-3


class _JaxUp(fnn.Module):
    """A transposed convolution named as the DPT head names its own."""

    name_: str
    k: int

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(x.shape[-1], (self.k, self.k), strides=(self.k, self.k),
                                 name=self.name_)(x)


class _Up(torch.nn.Module):
    def __init__(self, name: str, c: int, k: int):
        super().__init__()
        self.add_module(name, torch.nn.ConvTranspose2d(c, c, k, k))
        self.name_ = name

    def forward(self, x):
        return getattr(self, self.name_)(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name, k", [("up4", 4), ("up2", 2)])
def test_up4_up2_transposed_conversion(name, k):
    """flax's ConvTranspose with k = s under 'SAME' padding is torch's
    ConvTranspose2d(k, stride k) with the kernel flipped in both spatial
    axes. The kernel has as many input channels as outputs, so the two
    wrong conversions load without a shape error: each must give other
    outputs."""
    x = np.random.default_rng(k).standard_normal((2, 3, 4, 6)).astype(np.float32)
    jmod = _JaxUp(name, k)
    variables = init_perturbed(jmod, k, jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    assert want.shape == (2, 3 * k, 4 * k, 6)
    with torch.no_grad():
        got = n(load(_Up(name, 6, k), variables)(torch.from_numpy(x)))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        kernel = np.asarray(variables["params"][name]["kernel"])
        for wrong in (kernel.transpose(3, 2, 0, 1),                  # as an ordinary conv
                      kernel.transpose(2, 3, 0, 1)):                 # not flipped
            m = _Up(name, 6, k)
            m.load_state_dict({f"{name}.weight": torch.from_numpy(wrong.copy()),
                               f"{name}.bias": torch.from_numpy(
                                   np.asarray(variables["params"][name]["bias"]))})
            assert np.abs(n(m(torch.from_numpy(x))) - want).max() > 1e-2
    assert name in convert.TRANSPOSED
