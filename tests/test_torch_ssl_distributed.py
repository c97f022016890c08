"""The port's SSL step at two gloo ranks against the JAX `SSLMetaArch` on a
2-device mesh, in both mask forms: the gathered form (`MaskInfo`, at
--fsdp 1: the modules replicated, the gradients averaged by a flat
all-reduce) and the bool-mask form (`gathered=False`, at --fsdp 2: the
student and teacher under FSDP2, every parameter sharded). The model of
test_torch_pretrain (global crops 56, local 28, embed 32, depth 2, 64
prototypes, fp32), a global batch of 4 images split 2 + 2, the same state,
two steps at lr = 0: the three losses and the total of both, every student
gradient of the second (which a gradient left over from the first would
move), the teacher after both EMAs and both centres. Also
`sinkhorn_knopp` at two ranks against the JAX function on the global
batch, and the split of the masks by rank.

The JAX backbone runs its einsum attention with segment masks
(`attn_impl="einsum"`): the library flash attention's interpret mode
calls back to the host, which XLA cannot partition over two devices. The
port's plain K7 follows the library's rounding points, not the einsum's;
in fp32 that moves the results far less than the bounds below."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu.parallel.mesh import get_mesh
from adaptersis_tpu.ssl import losses as jl
from adaptersis_tpu.ssl.masking import MaskInfo as JaxMaskInfo
from adaptersis_tpu.ssl.meta_arch import SSLConfig as JaxSSLConfig, SSLMetaArch as JaxSSLMetaArch
from adaptersis_tpu_torch.models.layers import TRAINED
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.ssl.masking import (MaskingGenerator, collate_masks_with_indices,
                                              rank_masks)
from adaptersis_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch
from adaptersis_tpu_torch.train.convert import load_ssl_state, state_dict_to_flax
from torch_dist import crop_rows, rows, start, wait
from torch_parity import init_perturbed, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

SSL_IMPLS = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
VIT = dict(img_size=56, patch_size=14, embed_dim=32, depth=2, num_heads=2)
HEADS = dict(dino_out_dim=64, ibot_out_dim=64, head_hidden_dim=48, head_bottleneck_dim=16,
             n_local_crops=4)
B = 4                      # source images: 8 global crops, 16 local crops
SCHED = {"lr": 0.0, "wd": 0.04, "momentum": 0.9, "teacher_temp": 0.05, "last_layer_lr": 0.0}


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _state(jarch):
    """test_torch_pretrain's state: student and teacher apart, non-zero
    centres, Adam's state and the step at zero."""
    def branch(seed):
        return {"backbone": init_perturbed(jarch.backbone, seed,
                                           jnp.zeros((1, 56, 56, 3)))["params"],
                "dino_head": init_perturbed(jarch.dino_head, seed, jnp.zeros((1, 32)))["params"]}

    rng = np.random.default_rng(9)
    student = branch(1)
    return {"student": student, "teacher": branch(2),
            "opt_state": jax.device_get(jarch.tx.init(student)),
            "dino_center": 0.1 * rng.standard_normal((1, 64)).astype(np.float32),
            "ibot_center": 0.1 * rng.standard_normal((1, 1, 64)).astype(np.float32),
            "step": np.int32(0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' job started first, then two JAX steps in each form from the
    same state with lr = 0 (so the EMA compares like with like); the JAX
    gradients of the second step come out of Adam's first moment:
    mu₂ = β1·mu₁ + (1 − β1)·g₂."""
    d = tmp_path_factory.mktemp("ssl")
    rng = np.random.default_rng(3)
    g = rng.standard_normal((2 * B, 56, 56, 3)).astype(np.float32)
    l = rng.standard_normal((4 * B, 28, 28, 3)).astype(np.float32)
    info = collate_masks_with_indices(2 * B, 16, MaskingGenerator((4, 4), num_masking_patches=8),
                                      seed=11)
    teacher_out = rng.standard_normal((2 * B, 64)).astype(np.float32) * 0.2
    mesh = get_mesh(devices=jax.devices()[:2])
    jarch = JaxSSLMetaArch(JaxViT(attn_impl="einsum", **VIT), JaxSSLConfig(**HEADS), mesh=mesh)
    state = _state(jarch)
    arch = SSLMetaArch(DinoVisionTransformer(**SSL_IMPLS, **VIT), SSLConfig(**HEADS))
    load_ssl_state(arch, state)
    torch.save({"state": arch.state_dict(), "g": torch.from_numpy(g), "l": torch.from_numpy(l),
                "info": tuple(info), "B": B, "vit": VIT, "heads": HEADS, "sched": SCHED,
                "sinkhorn": torch.from_numpy(teacher_out)}, d / "ssl_in.pt")
    procs = start("ssl", d)

    sched = {k: np.full(2, v, np.float64) for k, v in SCHED.items()}
    want = {}
    for form, masks in (("gathered", JaxMaskInfo(*map(jnp.asarray, info))),
                        ("bool", jnp.asarray(info.masks))):
        new, losses, mus = jax.device_put(state), [], []
        for _ in range(2):
            new, metrics = jarch.train_step(new, jnp.asarray(g), jnp.asarray(l), masks, sched, 0)
            losses.append({k: float(v) for k, v in metrics.items()})
            mus.append(jax.device_get(new["opt_state"].mu))
        want[form] = (jax.device_get(new), losses, jax.tree_util.tree_map(
            lambda m2, m1: (m2 - 0.9 * m1) / (1 - 0.9), mus[1], mus[0]))
    want["sinkhorn"] = np.asarray(jl.sinkhorn_knopp(jnp.asarray(teacher_out), 0.05))
    wait(procs, d, "ssl", timeout=240)
    got = [torch.load(d / f"ssl.out{r}.pt", weights_only=False) for r in range(2)]
    return state, want, got, info


@pytest.mark.parametrize("form", ["gathered", "bool"])
def test_losses(runs, form):
    _, want, got, _ = runs
    for step, jloss in enumerate(want[form][1]):
        for r in range(2):
            tloss = got[r][form]["losses"][step]
            assert set(tloss) == set(jloss)
            for k, v in jloss.items():
                # test_torch_pretrain's bound: fp32 through two blocks, the
                # heads and the losses; the ranks' means and the gathered
                # KoLeo rows reorder the sums
                assert abs(tloss[k] - v) <= 1e-5 * max(1.0, abs(v)), (form, step, r, k,
                                                                       tloss[k], v)
        assert jloss["ibot"] > 0 and jloss["koleo"] != 0


@pytest.mark.parametrize("form", ["gathered", "bool"])
def test_student_gradients(runs, form):
    _, want, got, _ = runs
    jgrads = _leaves(want[form][2])
    tgrads = _leaves(state_dict_to_flax(got[0][form]["grads"])["params"])
    assert set(tgrads) == set(jgrads)
    top = max(np.abs(g).max() for g in jgrads.values())
    for path, g in jgrads.items():
        # test_torch_pretrain's bound: 1e-4 of each leaf's largest gradient
        scale = max(np.abs(g).max(), 1e-4 * top)
        np.testing.assert_allclose(tgrads[path], g, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"{form} {path}")
        assert np.abs(tgrads[path]).max() > 0, f"{form} {path} got no gradient"
    # every rank holds the same whole moments: its shards of the averaged
    # gradients went into them
    for a, b in zip(got[0][form]["mu"], got[1][form]["mu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["gathered", "bool"])
def test_teacher_ema_and_centres(runs, form):
    state, want, got, _ = runs
    new = want[form][0]
    flax = state_dict_to_flax(got[0][form]["state"])["params"]
    # lr = 0: the student is unchanged; the teacher took two EMA steps
    for tree in ("student", "teacher"):
        w, t = _leaves(new[tree]), _leaves(flax[tree])
        assert set(t) == set(w)
        for path, v in w.items():
            np.testing.assert_allclose(t[path], v, atol=1e-6 * max(1.0, np.abs(v).max()),
                                       rtol=0, err_msg=f"{form} {tree}/{path}")
    for c in ("dino_center", "ibot_center"):
        # global means over both ranks' rows (the iBOT centre over the masked
        # rows only), as the JAX step's over the global batch
        np.testing.assert_allclose(flax[c], np.asarray(new[c]), atol=1e-6, rtol=1e-5)
        assert not np.allclose(np.asarray(new[c]), state[c])


def test_sinkhorn_knopp_matches_global_batch(runs):
    _, want, got, _ = runs
    full = np.zeros_like(want["sinkhorn"])
    for r in range(2):
        full[rows(2 * B, r, 2)] = got[r]["sinkhorn"].numpy()
    assert np.isfinite(want["sinkhorn"]).all()
    # fp32, the global sums of 8 rows reduced in another order
    np.testing.assert_allclose(full, want["sinkhorn"], atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(full.sum(axis=1), 1.0, rtol=1e-5)


def test_rank_masks_cover_the_global_masks(runs):
    """Each rank's rows of the global masks, their gathered indices and
    weights; together the two ranks hold every masked token once."""
    *_, info = runs
    n_tokens = info.masks.shape[1]
    total = 0
    for r in range(2):
        mine = rank_masks(info, n_tokens, r, 2)
        np.testing.assert_array_equal(mine.masks, info.masks[crop_rows(B, 2, r, 2)])
        n = int(mine.n_masked)
        total += n
        np.testing.assert_array_equal(mine.indices[:n], np.nonzero(mine.masks.reshape(-1))[0])
        per = mine.masks.sum(axis=1)
        np.testing.assert_allclose(mine.weights[:n], 1.0 / per[mine.indices[:n] // n_tokens])
        assert not mine.weights[n:].any()
    assert total == int(info.n_masked)
    assert rank_masks(info, n_tokens, 0, 1) is info
