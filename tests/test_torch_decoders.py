"""The port's decoders, UNet bricks, PreViT and mask transformer against
the JAX package's modules (`models/decoders.py`, `unet_parts.py`,
`encoders.py:PreViT`, `masktrans.py`), fp32, every parameter and BatchNorm
statistic drawn from a seed and loaded through the weight bridge: the
forward in eval mode (running statistics) and in train mode (batch
statistics), and the new running statistics, within 1e-4 of the output's
scale. The transposed convolutions of Up and UpWC carry asymmetric seeded
kernels, so the bridge's kernel flip shows; the bridge's round trip is
the identity on them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models import decoders as jd, encoders as je, masktrans as jm
from adaptersis_tpu.models import unet_parts as ju
from adaptersis_tpu_torch.models import decoders as td, encoders as te, masktrans as tm
from adaptersis_tpu_torch.models import unet_parts as tu
from adaptersis_tpu_torch.train.convert import state_dict_to_flax
from torch_parity import load, n, perturb, single_thread  # noqa: F401  (fixture)


pytestmark = pytest.mark.usefixtures("single_thread")

def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


# name → (flax module, torch module, input shapes, static args, takes `train`)
CASES = {
    "ConvBNReluUp": (jd.ConvBNReluUp(8), td.ConvBNReluUp(4, 8), [(2, 5, 6, 4)], (), True),
    "ConvBNReluUp no upsample": (jd.ConvBNReluUp(8, upsample=False),
                                 td.ConvBNReluUp(4, 8, upsample=False), [(2, 5, 6, 4)], (),
                                 True),
    "LogitConv": (jd.LogitConv(3), td.LogitConv(4, 3), [(2, 5, 6, 4)], (), False),
    "DecoderSETR": (jd.DecoderSETR(3, features=(16, 8, 8, 4)),
                    td.DecoderSETR(12, 3, features=(16, 8, 8, 4)), [(2, 3, 3, 12)], (), True),
    "DecoderSETRF": (jd.DecoderSETRF(2, features=(8, 8, 6, 4)),
                     td.DecoderSETRF(12, (2, 3, 5), 2, features=(8, 8, 6, 4)),
                     [(2, 3, 3, 12), (2, 55, 55, 2), (2, 27, 27, 3), (2, 13, 13, 5)], (),
                     True),
    "MLAHead": (jd.MLAHead(8), td.MLAHead(6, 8), [(2, 3, 4, 6)] * 4, (), True),
    "DecoderMLA": (jd.DecoderMLA(img_size=40, mlahead_channels=8, num_classes=3),
                   td.DecoderMLA(6, img_size=40, mlahead_channels=8, num_classes=3),
                   [(2, 3, 3, 6)] * 4, (), True),
    "FusionModel": (jd.FusionModel(6, size=(7, 7)), td.FusionModel(4, 6, size=(7, 7)),
                    [(2, 5, 5, 4), (2, 7, 7, 6)], (), False),
    "FCUUp": (jd.FCUUp(6, 2), td.FCUUp(5, 6, 2), [(2, 3, 4, 5)], (3, 4), True),
    "FCUUp to 7x5": (jd.FCUUp(6, 1), td.FCUUp(5, 6, 1), [(2, 3, 2, 5)], (7, 5), True),
    "ConvBlock": (jd.ConvBlock(8), td.ConvBlock(8, 8), [(2, 6, 6, 8), (2, 6, 6, 2)], (), True),
    "ConvBlock res_conv stride 2": (jd.ConvBlock(8, stride=2, res_conv=True),
                                    td.ConvBlock(4, 8, stride=2, res_conv=True),
                                    [(2, 7, 7, 4)], (), True),
    "DecoderUNet": (jd.DecoderUNet(2, outplanes=1024, dw_stride=3), td.DecoderUNet(2, 6),
                    [(2, 48, 48, 3), (2, 1, 1, 6)], (), True),
    "DoubleConv": (ju.DoubleConv(6, mid_channels=3), tu.DoubleConv(4, 6, mid_ch=3),
                   [(2, 5, 5, 4)], (), True),
    "Down": (ju.Down(6), tu.Down(4, 6), [(2, 7, 7, 4)], (), True),
    "Up": (ju.Up(6), tu.Up(8, 4, 6), [(2, 3, 3, 8), (2, 7, 7, 4)], (), True),
    "Up bilinear": (ju.Up(6, bilinear=True), tu.Up(8, 4, 6, bilinear=True),
                    [(2, 3, 3, 8), (2, 7, 7, 4)], (), True),
    "UpWC": (ju.UpWC(6), tu.UpWC(8, 6), [(2, 3, 4, 8)], (), True),
    "UpWC bilinear": (ju.UpWC(6, bilinear=True), tu.UpWC(8, 6, bilinear=True),
                      [(2, 3, 4, 8)], (), True),
    "OutConv": (ju.OutConv(3), tu.OutConv(4, 3), [(2, 5, 5, 4)], (), False),
    "FeatureUNet": (ju.FeatureUNet(2, in_channels=16), tu.FeatureUNet(2, 16),
                    [(2, 5, 5, 16)], (), True),
    "FeatureUNet bilinear": (ju.FeatureUNet(2, in_channels=16, bilinear=True),
                             tu.FeatureUNet(2, 16, bilinear=True), [(2, 5, 5, 16)], (), True),
    "PreViT": (je.PreViT(4, 6, 8), te.PreViT(4, 6, 8), [(2, 8, 12, 6)], (), False),
    "PreViT norm, unflattened": (je.PreViT(4, 6, 8, use_norm=True, flatten_embedding=False),
                                 te.PreViT(4, 6, 8, use_norm=True, flatten_embedding=False),
                                 [(2, 8, 12, 6)], (), False),
    "MaskTransformer": (jm.MaskTransformer(3, 4, d_encoder=128), tm.MaskTransformer(3, 4, 128),
                        [(2, 12, 128)], ((12, 16),), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_jax(name):
    jmod, tmod, shapes, static, has_train = CASES[name]
    xs = [_x(s, i) for i, s in enumerate(shapes)]
    jx = [jnp.asarray(a) for a in xs]
    variables = perturb(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jx, *static)),
                        7)
    tmod = load(tmod, variables)
    modes = [("eval", {})] + ([("train", {"train": True})] if has_train else [])
    for mode, kw in modes:
        mutable = ["batch_stats"] if kw else False
        out = jax.jit(lambda v, *a: jmod.apply(v, *a, *static, mutable=mutable, **kw))(
            variables, *jx)
        want, stats = (out if kw else (out, None))
        want = np.asarray(want)
        tmod.train(bool(kw))
        with torch.no_grad():
            got = n(tmod(*[torch.from_numpy(a) for a in xs], *static))
        assert got.shape == want.shape, (mode, got.shape, want.shape)
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=mode)
        if stats is not None:
            mine = _leaves(state_dict_to_flax(tmod)["batch_stats"])
            ref = _leaves(stats["batch_stats"])
            assert set(mine) == set(ref) and ref
            for k, s in ref.items():
                np.testing.assert_allclose(mine[k], s, atol=1e-4 * max(1.0, np.abs(s).max()),
                                           rtol=0, err_msg=k)


@pytest.mark.parametrize("bilinear", [False, True])
def test_bridge_round_trips_the_unet(bilinear):
    """flax → torch → flax is the identity on FeatureUNet's variables, the
    transposed convolutions' kernels included."""
    jmod = ju.FeatureUNet(2, in_channels=16, bilinear=bilinear)
    variables = perturb(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                                         jnp.zeros((1, 5, 5, 16)))), 3)
    back = state_dict_to_flax(load(tu.FeatureUNet(2, 16, bilinear=bilinear), variables))
    for tree in ("params", "batch_stats"):
        want, got = _leaves(variables[tree]), _leaves(back[tree])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert bilinear or any(k.endswith("up/kernel") for k in _leaves(back["params"]))


def test_masktrans_attention_map():
    """MTBlock's return_attention hook: the softmax of the scaled scores."""
    jblk = jm.MTBlock(2, 512)
    x = _x((2, 9, 128), 5)
    variables = perturb(jax.eval_shape(lambda: jblk.init(jax.random.PRNGKey(0),
                                                         jnp.asarray(x))), 9)
    want = np.asarray(jblk.apply(variables, jnp.asarray(x), return_attention=True))
    with torch.no_grad():
        got = n(load(tm.MTBlock(128, 2, 512), variables)(torch.from_numpy(x),
                                                         return_attention=True))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
