"""The other backbones of `--arch` against the JAX package, fp32 on the CPU:
the SwiGLU block and blocks without LayerScale in both configurations
(deployed: Pallas in interpret mode on the JAX side; trained: the library
flash attention in the TPU interpreter, with input and parameter
gradients), the DINO-v1 backbone, register tokens through all four
forwards, the attention-map hook, the factories on the meta device, the
segmentors' refusals where the JAX package fails, and tiny `train_seg`
epochs on a v1 backbone and on a SwiGLU one picked by `--config_file`."""

import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.layers import Block as JaxBlock
from adaptersis_tpu.models.vit import ARCHS as JAX_ARCHS
from adaptersis_tpu.models.vit import DinoV1VisionTransformer as JaxV1
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu_torch import train_seg
from adaptersis_tpu_torch.models.layers import TRAINED, Block, SwiGLUFFNFused
from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.tap_segmentor import TapSegmentor
from adaptersis_tpu_torch.models.vit import (
    ARCHS, WINDOWED, DinoV1VisionTransformer, DinoVisionTransformer, build_backbone)
from adaptersis_tpu_torch.train.convert import _param, state_dict_to_flax
from torch_parity import (  # noqa: F401  (fixtures)
    init_perturbed, interpret_library_flash, interpret_pallas, load, n, single_thread, t)

pytestmark = pytest.mark.usefixtures("single_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAMES = ("attn_impl", "ln_impl", "qkv_impl", "mlp_impl")
JAX_DEPLOYED = dict(zip(NAMES, ("flash_fwd", "pallas", "pallas", "pallas")))
SSL_IMPLS = dict(zip(NAMES, TRAINED))
VIT = dict(img_size=56, patch_size=14, embed_dim=64, depth=3, num_heads=2)
# fp32 on both sides: flax's LayerNorm takes the variance as E[x²] − E[x]²,
# torch's in two passes; ~1e-6 per block, more through a backward
ATOL = 2e-5


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads(module, want):
    got = _leaves(state_dict_to_flax({k: p.grad for k, p in module.named_parameters()})["params"])
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, atol=ATOL * max(1.0, np.abs(g).max()),
                                   rtol=0, err_msg=path)


def _images(seed, B=2, size=84):
    return np.random.default_rng(seed).uniform(0, 1, (B, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("ffn_layer, init_values, gelu_approx", [
    ("swiglufused", 1e-5, False), ("swiglufused", 1e-5, True),
    ("mlp", None, False), ("mlp", None, True)])
def test_deployed_block(ffn_layer, init_values, gelu_approx):
    """K4 → K3 → proj, then the MLP half as the JAX package dispatches it:
    none of these cases may take K5 (SwiGLU, or no LayerScale), so K6 and
    the plain FFN run."""
    x = np.random.default_rng(3).standard_normal((2, 37, 64)).astype(np.float32)
    jblk = JaxBlock(64, 2, init_values=init_values, ffn_layer=ffn_layer,
                    gelu_approx=gelu_approx, **JAX_DEPLOYED)
    with interpret_pallas():
        variables = init_perturbed(jblk, 5, jnp.asarray(x))
        want = np.asarray(jblk.apply(variables, jnp.asarray(x)))
    blk = load(Block(64, 2, init_values=init_values, gelu_approx=gelu_approx,
                     ffn_layer=ffn_layer), variables)
    assert not blk.fused_mlp
    assert ("ls1.gamma" in blk.state_dict()) == (init_values is not None)
    with torch.no_grad():
        np.testing.assert_allclose(n(blk(t(x))), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ffn_layer, init_values", [("swiglufused", 1e-5), ("mlp", None)])
def test_trained_block_and_gradients(ffn_layer, init_values):
    """The SSL configuration of a SwiGLU block and of a block without
    LayerScale: forward, input and parameter gradients with segment ids."""
    rng = np.random.default_rng(1)
    B, N, C = 2, 45, 64
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    w = rng.standard_normal((B, N, C)).astype(np.float32)
    ids = np.broadcast_to(np.r_[np.zeros(25), np.ones(20)].astype(np.int32), (B, N)).copy()
    jblk = JaxBlock(C, 2, init_values=init_values, ffn_layer=ffn_layer, attn_impl="flash")
    variables = init_perturbed(jblk, 2, jnp.asarray(x))

    def loss(v, x):
        return (jblk.apply(v, x, segment_ids=jnp.asarray(ids)) * w).sum()

    with interpret_library_flash():
        want = np.asarray(jblk.apply(variables, jnp.asarray(x), segment_ids=jnp.asarray(ids)))
        gv, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables, jnp.asarray(x))
    blk = load(Block(C, 2, init_values=init_values, ffn_layer=ffn_layer, **SSL_IMPLS), variables)
    tx = t(x).requires_grad_()
    out = blk(tx, torch.from_numpy(ids))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(n(out), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(n(tx.grad), np.asarray(gx), atol=ATOL, rtol=0)
    _assert_grads(blk, _leaves(gv["params"]))


def test_swiglu_hidden_width():
    """DINOv2's fused sizing: ViT-g's 1536 → 4096."""
    with torch.device("meta"):
        ffn = SwiGLUFFNFused(1536)
    assert tuple(ffn.w12.weight.shape) == (8192, 1536)
    assert tuple(ffn.w3.weight.shape) == (1536, 4096)


def test_v1_backbone():
    """DINO-v1: no LayerScale, `forward` gives the normed patch tokens, and
    `get_intermediate_layers` the last n blocks' normed tokens with cls."""
    x = _images(0)
    jvit = JaxV1(init_values=None, **JAX_DEPLOYED, **VIT)

    def both(m, x):
        return m(x), m.get_intermediate_layers(x, 2)

    with interpret_pallas():
        variables = init_perturbed(jvit, 4, jnp.asarray(x))
        want = jax.tree_util.tree_map(np.asarray,
                                      jvit.apply(variables, jnp.asarray(x), method=both))
    vit = load(DinoV1VisionTransformer(init_values=None, **VIT), variables)
    assert not any(k.endswith("gamma") for k in vit.state_dict())
    with torch.no_grad():
        got = vit(t(x)), vit.get_intermediate_layers(t(x), 2)
    assert got[0].shape == (2, 36, 64) and [g.shape for g in got[1]] == [(2, 37, 64)] * 2
    for g, e in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(n, got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=0)


REG = 4


def test_register_tokens_deployed_forwards():
    """r = 4 register tokens after cls: forward_with_masks (all four keys,
    with iBOT masks) and get_intermediate_layers with reshape and the class
    token, in the deployed configuration."""
    x = _images(1)
    masks = np.random.default_rng(2).uniform(size=(2, 36)) < 0.4
    jvit = JaxViT(num_register_tokens=REG, gelu_approx=True, **JAX_DEPLOYED, **VIT)

    def both(m, x):
        return (m.forward_with_masks(x, masks=jnp.asarray(masks)),
                m.get_intermediate_layers(x, 2, reshape=True, return_class_token=True))

    with interpret_pallas():
        variables = init_perturbed(jvit, 6, jnp.asarray(x))
        want = jax.tree_util.tree_map(np.asarray,
                                      jvit.apply(variables, jnp.asarray(x), method=both))
    vit = load(DinoVisionTransformer(num_register_tokens=REG, gelu_approx=True, **VIT), variables)
    assert vit.register_tokens.shape == (1, REG, 64)
    with torch.no_grad():
        out = vit.forward_with_masks(t(x), masks=torch.from_numpy(masks))
        taps = vit.get_intermediate_layers(t(x), 2, reshape=True, return_class_token=True)
    assert set(out) == set(want[0])
    assert out["x_norm_regtokens"].shape == (2, REG, 64)
    assert out["x_prenorm"].shape == (2, 1 + REG + 36, 64)
    for k, e in want[0].items():
        np.testing.assert_allclose(n(out[k]), e, atol=ATOL, rtol=0, err_msg=k)
    assert [(p.shape, c.shape) for p, c in taps] == [((2, 6, 6, 64), (2, 64))] * 2
    for (p, c), (ep, ec) in zip(taps, want[1]):
        np.testing.assert_allclose(n(p), ep, atol=ATOL, rtol=0)
        np.testing.assert_allclose(n(c), ec, atol=ATOL, rtol=0)


def test_register_tokens_packed_crops_and_gradients():
    """forward_packed_crops with r = 4 and iBOT masks in the trained
    configuration: the patch tokens start after the registers; gradients
    reach them."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
    l = rng.standard_normal((8, 14, 14, 3)).astype(np.float32)
    masks = rng.uniform(size=(4, 4)) > 0.5
    kw = dict(VIT, img_size=28, depth=2)
    jvit = JaxViT(num_register_tokens=REG, attn_impl="flash", **kw)
    variables = init_perturbed(jvit, 7, jnp.asarray(g))

    def fwd(v):
        outs = jvit.apply(v, jnp.asarray(g), jnp.asarray(l), masks=jnp.asarray(masks),
                          method=jvit.forward_packed_crops)
        return [o[k] for o in outs for k in ("x_norm_clstoken", "x_norm_patchtokens")]

    with interpret_library_flash():
        want = jax.jit(fwd)(variables)
        weights = [rng.standard_normal(np.shape(w)).astype(np.float32) for w in want]
        grads = jax.jit(jax.grad(lambda v: sum((o * w).sum()
                                               for o, w in zip(fwd(v), weights))))(variables)
    vit = load(DinoVisionTransformer(num_register_tokens=REG, **SSL_IMPLS, **kw), variables)
    outs = vit.forward_packed_crops(t(g), t(l), masks=torch.from_numpy(masks))
    got = [o[k] for o in outs for k in ("x_norm_clstoken", "x_norm_patchtokens")]
    assert [tuple(o.shape) for o in got] == [(4, 64), (4, 4, 64), (8, 64), (8, 1, 64)]
    sum((o * t(w)).sum() for o, w in zip(got, weights)).backward()
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=ATOL, rtol=0)
    _assert_grads(vit, _leaves(grads["params"]))
    assert np.abs(n(vit.register_tokens.grad)).max() > 0


@pytest.mark.parametrize("v1", [False, True])
def test_get_last_selfattention(v1):
    """The last block's attention probabilities (B, H, N, N), fp32, from
    the same q and k as the block's kernels read (K4 on the port's side)."""
    x = _images(4 + v1)
    cls, tcls = (JaxV1, DinoV1VisionTransformer) if v1 else (JaxViT, DinoVisionTransformer)
    extra = dict(init_values=None) if v1 else {}
    jvit = cls(**extra, **JAX_DEPLOYED, **VIT)
    with interpret_pallas():
        variables = init_perturbed(jvit, 8, jnp.asarray(x))
        want = np.asarray(jvit.apply(variables, jnp.asarray(x),
                                     method=jvit.get_last_selfattention))
    vit = load(tcls(**extra, **VIT), variables)
    with torch.no_grad():
        got = vit.get_last_selfattention(t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, 37, 37)
    np.testing.assert_allclose(n(got), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(n(got.sum(-1)), 1.0, atol=1e-6)


def _flax_shapes(arch):
    """The JAX factory's parameter shapes under the port's names, through
    the weight bridge's name map (on zero-strided arrays: no weights)."""
    shapes = jax.eval_shape(lambda: JAX_ARCHS[arch](img_size=518, patch_size=14).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 14, 14, 3))))
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(shapes["params"]):
        name, a = _param(tuple(p.key for p in path), np.broadcast_to(np.zeros((), bool), s.shape))
        out[name] = a.shape
    return out


@pytest.mark.parametrize("arch", ["vit_giant2", "vit_tiny", "vit_tiny_v1", "vit_small_v1",
                                  "vit_base_v1", "vit_small_windowed", "vit_large_windowed"])
def test_factories_on_the_meta_device(arch):
    """Names and shapes of every new factory equal the JAX factory's, the
    v1 backbones have no LayerScale, and the windowed ones window every
    block but the last of each quarter."""
    with torch.device("meta"):      # shapes and names only, no weights
        vit = build_backbone(arch, img_size=518, patch_size=14)
    got = {k: tuple(v.shape) for k, v in vit.state_dict().items()}
    want = _flax_shapes(arch)
    assert got == want
    assert isinstance(vit, DinoV1VisionTransformer) == arch.endswith("_v1")
    assert ("blocks.0.ls1.gamma" in got) == (not arch.endswith("_v1"))
    windowed = [blk.windowed for blk in vit.blocks]
    assert windowed == ([(i + 1) % (len(windowed) // 4) != 0 for i in range(len(windowed))]
                        if arch.endswith("_windowed") else [False] * len(windowed))
    if arch == "vit_giant2":
        assert len(vit.blocks) == 40 and vit.blocks[0].attn.num_heads == 24
        assert got["blocks.39.mlp.w12.weight"] == (8192, 1536)
        assert got["blocks.39.mlp.w3.weight"] == (1536, 4096)


def test_archs_cover_the_jax_package_but_the_windowed_ones():
    """Since the Mask2Former slice the windowed ones are covered too."""
    assert set(ARCHS) == set(JAX_ARCHS)
    assert set(WINDOWED) == {a for a in JAX_ARCHS if a.endswith("_windowed")}
    for arch in WINDOWED:
        with torch.device("meta"):
            vit = build_backbone(arch)
        assert any(blk.windowed for blk in vit.blocks)
    with pytest.raises(ValueError, match="unknown arch"):
        build_backbone("vit_huge")
    with pytest.raises(ValueError, match="unknown ffn_layer"):
        Block(64, 2, ffn_layer="swiglu")


def test_segmentors_refuse_what_the_jax_package_fails_on():
    """Register tokens under the adapter segmentor and a v1 backbone under a
    tap model raise at construction; a v1 backbone under the adapter model
    builds (the JAX package runs it too)."""
    with pytest.raises(ValueError, match="register tokens"):
        AdapterSegmentor(DinoVisionTransformer(num_register_tokens=4, **VIT))
    for decoder in ("setr", "setr_ete"):
        with pytest.raises(ValueError, match="DINO-v1"):
            TapSegmentor(DinoV1VisionTransformer(init_values=None, **VIT), decoder=decoder)
    TapSegmentor(DinoVisionTransformer(num_register_tokens=4, **VIT), decoder="setr")
    AdapterSegmentor(DinoV1VisionTransformer(init_values=None, **VIT), encoder_inplanes=16)


TINY = ["--patch_size", "14", "--imsize", "56", "--device", "cpu", "--batch_size_per_gpu", "2",
        "--synthetic", "--epochs", "1"]


def _trained_a_tiny_epoch(hist, out) -> set:
    """Checks the epoch's stats and files; returns the flax paths saved."""
    stats = hist[0]
    assert len(stats["train_losses"]) == 8 and stats["train_losses_finite"]
    for k in ("train_loss", "test_loss", "test_dice", "test_acc1"):
        assert np.isfinite(stats[k]), k
    with np.load(out / "variables.npz") as f:
        return set(f.files)


def test_train_seg_tiny_epoch_on_a_v1_backbone(tmp_path):
    saved = _trained_a_tiny_epoch(train_seg.main(
        ["--arch", "vit_tiny_v1", *TINY, "--output_dir", str(tmp_path)]), tmp_path)
    assert "params/backbone/blocks_11/mlp/fc1/kernel" in saved
    assert not any("/ls1/" in k for k in saved)


def test_train_seg_tiny_epoch_on_a_swiglu_config(tmp_path, monkeypatch):
    """A narrowed SwiGLU backbone through `--config_file` (a YAML in the
    layout of `configs/vitg14_pretrain.yaml`); that file itself selects
    vit_giant2."""
    monkeypatch.setitem(ARCHS, "vit_test_swiglu", partial(
        DinoVisionTransformer, embed_dim=64, depth=5, num_heads=4, ffn_layer="swiglufused"))
    cfg = tmp_path / "swiglu.yaml"
    cfg.write_text("student:\n  arch: vit_test_swiglu\n  patch_size: 14\n"
                   "  ffn_layer: swiglufused\ncrops:\n  global_crops_size: 518\n")
    out = tmp_path / "out"
    saved = _trained_a_tiny_epoch(train_seg.main(
        ["--config_file", str(cfg), "--arch", "vit_small", *TINY, "--output_dir", str(out)]), out)
    assert "params/backbone/blocks_4/mlp/w12/kernel" in saved
    args = train_seg.get_args_parser().parse_args(
        ["--config_file", os.path.join(ROOT, "configs", "vitg14_pretrain.yaml")])
    assert train_seg._arch_from_config(args) == ("vit_giant2", 14)
