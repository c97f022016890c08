"""The port's SSL modules against the JAX package's, fp32, with the library
flash attention in interpret mode: the trained `Block` and the ViT's
`forward_with_masks` / `forward_packed_crops` (outputs and parameter
gradients), `DINOHead`, every loss, the masks (bit-equal), the multi-crop
augmentation on the JAX function's own draws; and the layerwise lr-decay
table against an independent re-derivation of upstream DINOv2's formula."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.layers import Block as JaxBlock
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT, vit_small as jax_vit_small
from adaptersis_tpu.ssl import losses as jl
from adaptersis_tpu.ssl import masking as jm
from adaptersis_tpu.ssl.augment import multicrop_augment
from adaptersis_tpu.ssl.heads import DINOHead as JaxDINOHead
from adaptersis_tpu.ssl.meta_arch import SSLConfig as JaxSSLConfig, SSLMetaArch as JaxSSLMetaArch
from adaptersis_tpu_torch.models.layers import DEPLOYED, TRAINED, Block
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer, build_backbone
from adaptersis_tpu_torch.ssl import losses as tl
from adaptersis_tpu_torch.ssl import masking as tm
from adaptersis_tpu_torch.ssl.augment import apply_multicrop, draw_multicrop
from adaptersis_tpu_torch.ssl.heads import DINOHead
from adaptersis_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch, decays
from adaptersis_tpu_torch.train.convert import state_dict_to_flax
from torch_parity import init_perturbed, library_flash_interpret, load, n, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("library_flash_interpret")

SSL_IMPLS = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
VIT = dict(img_size=28, patch_size=14, embed_dim=32, depth=2, num_heads=2)
# fp32 on both sides; flax LayerNorm's variance is E[x²] − E[x]², torch's
# two-pass: ~1e-6 per block, more through the backward
ATOL = 2e-5


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _grads_as_flax(module):
    return _leaves(state_dict_to_flax({k: p.grad for k, p in module.named_parameters()})["params"])


def _assert_grads(got, want):
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, atol=ATOL * max(1.0, np.abs(g).max()),
                                   rtol=0, err_msg=path)


def test_trained_block_and_gradients():
    """The SSL Block (LN, qkv, K7 with segment ids, proj, exact-GELU MLP,
    LayerScale) and its parameter and input gradients."""
    rng = np.random.default_rng(0)
    B, N, C = 2, 45, 32
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    w = rng.standard_normal((B, N, C)).astype(np.float32)
    ids = np.broadcast_to(np.r_[np.zeros(25), np.ones(10), 2 * np.ones(10)].astype(np.int32),
                          (B, N)).copy()
    jblk = JaxBlock(C, 2, attn_impl="flash")
    variables = init_perturbed(jblk, 1, jnp.asarray(x))

    def loss(v, x):
        return (jblk.apply(v, x, segment_ids=jnp.asarray(ids)) * w).sum()

    want = np.asarray(jblk.apply(variables, jnp.asarray(x), segment_ids=jnp.asarray(ids)))
    gv, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables, jnp.asarray(x))
    blk = load(Block(C, 2, **SSL_IMPLS), variables)
    tx = t(x).requires_grad_()
    out = blk(tx, torch.from_numpy(ids))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(n(out), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(n(tx.grad), np.asarray(gx), atol=ATOL, rtol=0)
    _assert_grads(_grads_as_flax(blk), _leaves(gv["params"]))


def test_only_the_two_configurations_are_accepted():
    Block(32, 2)                      # the deployed frozen walks
    Block(32, 2, **SSL_IMPLS)         # the SSL step
    assert DEPLOYED != TRAINED
    with pytest.raises(ValueError, match="not ported"):
        Block(32, 2, attn_impl="flash", ln_impl="pallas", qkv_impl="xla", mlp_impl="xla")
    with pytest.raises(ValueError, match="not ported"):
        DinoVisionTransformer(attn_impl="einsum", ln_impl="xla", qkv_impl="xla",
                              mlp_impl="xla", **VIT)


@pytest.mark.parametrize("packed", [True, False])
def test_vit_ssl_forwards_and_gradients(packed):
    """forward_packed_crops (the student: 2 local crops packed with each
    global crop) or forward_with_masks on the global crops alone, with iBOT
    mask tokens on the global crops."""
    rng = np.random.default_rng(1 + packed)
    g = rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
    l = rng.standard_normal((8, 14, 14, 3)).astype(np.float32)
    masks = rng.uniform(size=(4, 4)) > 0.5
    jvit = JaxViT(attn_impl="flash", **VIT)
    variables = init_perturbed(jvit, 7, jnp.asarray(g))

    def pick(out):
        outs = out if packed else (out,)
        return [o[k] for o in outs for k in ("x_norm_clstoken", "x_norm_patchtokens")]

    def jax_fwd(v):
        if packed:
            return pick(jvit.apply(v, jnp.asarray(g), jnp.asarray(l), masks=masks,
                                   method=jvit.forward_packed_crops))
        return pick(jvit.apply(v, jnp.asarray(g), masks=masks, method=jvit.forward_with_masks))

    want = jax.jit(jax_fwd)(variables)
    weights = [rng.standard_normal(np.shape(w)).astype(np.float32) for w in want]
    grads = jax.jit(jax.grad(lambda v: sum((o * w).sum()
                                           for o, w in zip(jax_fwd(v), weights))))(variables)
    vit = load(DinoVisionTransformer(**SSL_IMPLS, **VIT), variables)
    tmasks = torch.from_numpy(masks)
    got = pick(vit.forward_packed_crops(t(g), t(l), masks=tmasks) if packed else
               vit.forward_with_masks(t(g), masks=tmasks))
    sum((o * t(w)).sum() for o, w in zip(got, weights)).backward()
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=ATOL, rtol=0)
    _assert_grads(_grads_as_flax(vit), _leaves(grads["params"]))
    assert np.abs(n(vit.mask_token.grad)).max() > 0


def test_dino_head():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    jhead = JaxDINOHead(64, hidden_dim=48, bottleneck_dim=16)
    variables = init_perturbed(jhead, 4, jnp.asarray(x))
    head = load(DINOHead(32, 64, hidden_dim=48, bottleneck_dim=16), variables)
    np.testing.assert_allclose(n(head(t(x))), np.asarray(jhead.apply(variables, jnp.asarray(x))),
                               atol=1e-5, rtol=0)


def test_losses_and_centres():
    rng = np.random.default_rng(4)
    K, B2, N, U = 24, 6, 10, 13
    s = [rng.standard_normal((B2, K)).astype(np.float32) for _ in range(3)]
    te = [rng.standard_normal((B2, K)).astype(np.float32) for _ in range(2)]
    c = 0.1 * rng.standard_normal((1, K)).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    close = (lambda a, b: np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5, rtol=1e-6))
    close(tl.softmax_center_teacher(T(te[0]), T(c), 0.07),
          jl.softmax_center_teacher(J(te[0]), J(c), 0.07))
    close(tl.update_center(T(c), T(te[1]), 0.9), jl.update_center(J(c), J(te[1]), 0.9))
    tt = [tl.softmax_center_teacher(T(x), T(c), 0.04) for x in te]
    jt = [jl.softmax_center_teacher(J(x), J(c), 0.04) for x in te]
    close(tl.dino_loss([T(x) for x in s], tt), jl.dino_loss([J(x) for x in s], jt))
    sp = rng.standard_normal((B2, N, K)).astype(np.float32)
    tp = np.asarray(jax.nn.softmax(J(rng.standard_normal((B2, N, K)).astype(np.float32))))
    mask = rng.uniform(size=(B2, N)) > 0.6
    mask[0] = False
    tp = tp.copy()
    close(tl.ibot_patch_loss(T(sp), T(tp), T(mask)), jl.ibot_patch_loss(J(sp), J(tp), J(mask)))
    w = np.zeros(U, np.float32)
    w[:9] = rng.uniform(0.1, 1.0, 9)
    su = rng.standard_normal((U, K)).astype(np.float32)
    close(tl.ibot_patch_loss_masked(T(su), T(tp.reshape(-1, K)[:U]), T(w), B2),
          jl.ibot_patch_loss_masked(J(su), J(tp.reshape(-1, K)[:U]), J(w), B2))
    close(tl.update_center_masked(T(c), T(tp.reshape(-1, K)[:U]), T(w), torch.tensor(9)),
          jl.update_center_masked(J(c), J(tp.reshape(-1, K)[:U]), J(w), J(np.int32(9))))
    close(tl.koleo_loss(T(s[0])), jl.koleo_loss(J(s[0])))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_masks_are_bit_equal(seed):
    for grid, B in (((16, 16), 64), ((4, 4), 8)):
        n_tok = grid[0] * grid[1]
        want = jm.collate_masks_with_indices(B, n_tok, jm.MaskingGenerator(
            grid, num_masking_patches=n_tok // 2), seed=seed)
        got = tm.collate_masks_with_indices(B, n_tok, tm.MaskingGenerator(
            grid, num_masking_patches=n_tok // 2), seed=seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert got.masks.any()
        assert tm.mask_upperbound(B, n_tok) == jm.mask_upperbound(B, n_tok)
        gen = (jm.MaskingGenerator(grid, n_tok // 2), tm.MaskingGenerator(grid, n_tok // 2))
        np.testing.assert_array_equal(gen[1](n_tok // 3, seed=seed), gen[0](n_tok // 3, seed=seed))


def _jax_multicrop_draws(rng, B, n_local):
    """The draws of `multicrop_augment`, by its own random calls on its keys."""
    keys = jax.random.split(rng, B * (2 + n_local)).reshape(B, 2 + n_local, 2)
    names = ("area", "log_r", "uy", "ux", "flip", "jitter", "bright", "contrast", "sat",
             "gray", "blur", "sigma", "solarize")
    cols = {k: np.zeros((B, 2 + n_local), np.float32) for k in names}
    unif = jax.random.uniform
    for b in range(B):
        for j in range(2 + n_local):
            kc, kf, kj, kb, ks = jax.random.split(keys[b, j], 5)
            k1, k2, k3, k4 = jax.random.split(kc, 4)
            scale = (0.32, 1.0) if j < 2 else (0.05, 0.32)
            kb_, kc_, ks_, _, kp_, kg_ = jax.random.split(kj, 6)
            kp2, ks2 = jax.random.split(kb)
            blur_p = (1.0, 0.1)[j] if j < 2 else 0.5
            vals = dict(
                area=unif(k1, (), minval=scale[0], maxval=scale[1]),
                log_r=unif(k2, (), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3)),
                uy=unif(k3, ()), ux=unif(k4, ()), flip=jax.random.bernoulli(kf, 0.5),
                jitter=jax.random.bernoulli(kp_, 0.8),
                bright=1 + unif(kb_, (), minval=-0.4, maxval=0.4),
                contrast=1 + unif(kc_, (), minval=-0.4, maxval=0.4),
                sat=1 + unif(ks_, (), minval=-0.2, maxval=0.2),
                gray=jax.random.bernoulli(kg_, 0.2), blur=jax.random.bernoulli(kp2, blur_p),
                sigma=unif(ks2, (), minval=0.1, maxval=2.0),
                solarize=jax.random.bernoulli(ks, 0.2 if j == 1 else 0.0))
            for k, v in vals.items():
                cols[k][b, j] = float(v)
    return {k: torch.from_numpy(v.astype(bool) if k in ("flip", "jitter", "gray", "blur",
                                                         "solarize") else v)
            for k, v in cols.items()}


@pytest.mark.parametrize("seed", [0, 3])
def test_multicrop_matches_jax_on_the_same_draws(seed):
    B, n_local, S = 3, 2, 40
    imgs = np.random.default_rng(seed).integers(0, 256, (B, S, S, 3), np.uint8)
    rng = jax.random.PRNGKey(seed)
    wg, wl = multicrop_augment(jnp.asarray(imgs), rng, global_size=28, local_size=14,
                               n_local=n_local)
    draws = _jax_multicrop_draws(rng, B, n_local)
    for k in ("flip", "jitter", "gray", "blur"):
        assert draws[k].any(), k            # each branch is taken somewhere
    g, l = apply_multicrop(torch.from_numpy(imgs), draws, 28, 14)
    assert g.shape == (2 * B, 28, 28, 3) and l.shape == (n_local * B, 14, 14, 3)
    # fp32 on both sides: interpolation and blur as sums of the same
    # products in other orders (the JAX package as matmuls), then / std
    np.testing.assert_allclose(n(g), np.asarray(wg), atol=1e-4, rtol=0)
    np.testing.assert_allclose(n(l), np.asarray(wl), atol=1e-4, rtol=0)
    d = draw_multicrop(torch.Generator().manual_seed(0), B, n_local)
    assert all(v.shape == (B, 2 + n_local) for v in d.values())
    assert d["blur"][:, 0].all() and not d["solarize"][:, [0, 2, 3]].any()


def _upstream_lr_decay_rate(name: str, lr_decay_rate: float, num_layers: int) -> float:
    """Upstream DINOv2's get_vit_lr_decay_rate (dinov2/utils/param_groups.py),
    re-derived for the port's parameter names: the embeddings and tokens
    are layer 0, block i is layer i + 1, anything else is layer
    num_layers + 1; the rate is lr_decay_rate^(num_layers + 1 − layer)."""
    layer_id = num_layers + 1
    if name.startswith("backbone"):
        if any(f".{t}" in name for t in ("pos_embed", "patch_embed", "mask_token", "cls_token",
                                         "register_tokens")):
            layer_id = 0
        elif ".blocks." in name:
            layer_id = int(re.search(r"\.blocks\.(\d+)\.", name).group(1)) + 1
    return lr_decay_rate ** (num_layers + 1 - layer_id)


def test_lr_decay_table_matches_upstream_formula():
    """The independent oracle: upstream's formula times the patch-embed
    multiplier (get_params_groups_with_decay: ×0.2 on patch_embed), held
    against the port's multipliers at depth 12 (ViT-S/14), which must also
    match the JAX package's table path by path."""
    with torch.device("meta"):
        arch = SSLMetaArch(build_backbone("vit_small", img_size=224, **SSL_IMPLS),
                           SSLConfig(dino_out_dim=64, ibot_out_dim=64))
    got = arch.lr_multipliers()
    assert any(".blocks.10." in k for k in got) and any(".blocks.1." in k for k in got)
    for name, m in got.items():
        want = _upstream_lr_decay_rate(name, 0.9, 12) * (0.2 if "patch_embed" in name else 1.0)
        assert m == pytest.approx(want, rel=1e-12), name
    jbb = jax_vit_small(img_size=224, patch_size=14)
    jarch = JaxSSLMetaArch(jbb, JaxSSLConfig(dino_out_dim=64, ibot_out_dim=64))
    shapes = jax.eval_shape(lambda: {"backbone": jbb.init(jax.random.PRNGKey(0),
                                                          jnp.zeros((1, 224, 224, 3)))["params"]})

    def torch_name(path):
        *mod, leaf = path.split("/")
        leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        return re.sub(r"blocks_(\d+)", r"blocks.\1", ".".join(mod + [leaf]))

    jmult = {torch_name(p): float(m) for p, m in _leaves(jarch.lr_multipliers(shapes)).items()}
    assert jmult == pytest.approx({k: m for k, m in got.items() if k.startswith("backbone.")},
                                  rel=1e-12)
    # weight decay: matrices and kernels only
    named = dict(arch.student.named_parameters())
    assert decays("backbone.blocks.0.attn.qkv.weight", named["backbone.blocks.0.attn.qkv.weight"])
    assert decays("dino_head.last_layer_v", named["dino_head.last_layer_v"])
    for k in ("backbone.blocks.0.ls1.gamma", "backbone.mask_token", "backbone.pos_embed",
              "dino_head.last_layer_g", "backbone.norm.weight", "dino_head.mlp_0.bias"):
        assert not decays(k, named[k]), k
