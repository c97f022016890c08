"""Port's ViT (Block, DinoVisionTransformer) against the JAX package with
attn_impl="flash_fwd" (Pallas in interpret mode) and gelu_approx=True."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.layers import Block as JaxBlock
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu_torch.models.layers import Block
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer, build_backbone
from torch_parity import init_perturbed, load, n, pallas_interpret, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("pallas_interpret")

# fp32 on both sides. Flax LayerNorm takes the variance as E[x²] − E[x]²,
# torch in two passes; with the projections that leaves ~1e-6 per block
ATOL = 2e-5


@pytest.mark.parametrize("N", [37, 36])
def test_block(N):
    x = np.random.default_rng(N).standard_normal((2, N, 128)).astype(np.float32)
    jblk = JaxBlock(128, 2, attn_impl="flash_fwd", gelu_approx=True)
    variables = init_perturbed(jblk, N, jnp.asarray(x))
    expect = np.asarray(jblk.apply(variables, jnp.asarray(x)))
    blk = load(Block(128, 2, gelu_approx=True), variables)
    with torch.no_grad():
        np.testing.assert_allclose(n(blk(t(x))), expect, atol=ATOL, rtol=0)


def test_backbone_pieces():
    """embed with and without cls/pos (pos grid 4×4 interpolated to 6×6),
    the last-2 block taps, and the final norm."""
    kw = dict(img_size=56, patch_size=14, embed_dim=128, depth=3, num_heads=2)
    x = np.random.default_rng(0).uniform(0, 1, (2, 84, 84, 3)).astype(np.float32)
    jvit = JaxViT(attn_impl="flash_fwd", gelu_approx=True, **kw)

    def pieces(m, x):
        tokens, _ = m.embed(x, with_pos_cls=True)
        bare, _ = m.embed(x, with_pos_cls=False)
        taps = m.collect_block_outputs(tokens, [1, 2])
        return tokens, bare, taps, [m.final_norm(tp) for tp in taps]

    variables = init_perturbed(jvit, 1, jnp.asarray(x))
    expect = jax.tree_util.tree_map(np.asarray,
                                    jvit.apply(variables, jnp.asarray(x), method=pieces))
    vit = load(DinoVisionTransformer(gelu_approx=True, **kw), variables)
    with torch.no_grad():
        got = pieces(vit, t(x))
    for e, g in zip(jax.tree_util.tree_leaves(expect),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(n, got))):
        np.testing.assert_allclose(g, e, atol=ATOL, rtol=0)


def test_build_backbone_factories():
    with torch.device("meta"):      # shapes and names only, no 1.2 GB of weights
        vit = build_backbone("vit_large", img_size=518, patch_size=14)
    assert (vit.embed_dim, vit.depth, len(vit.blocks), vit.pos_embed.shape[1]) == \
        (1024, 24, 24, 37 * 37 + 1)
    assert vit.blocks[0].attn.num_heads == 16
    # DINOv2 state-dict names, so its checkpoints load without remapping
    names = set(vit.state_dict())
    for key in ("blocks.0.norm1.weight", "blocks.0.attn.qkv.weight", "blocks.0.ls1.gamma",
                "blocks.23.mlp.fc1.weight", "norm.weight", "patch_embed.proj.weight",
                "cls_token", "pos_embed", "mask_token"):
        assert key in names, key
    with pytest.raises(ValueError, match="unknown arch"):
        build_backbone("vit_huge")
