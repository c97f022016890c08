"""The port's SSL train step against the JAX package's `SSLMetaArch.train_step`
on a narrow model (global crops 56, local 28, embed 32, 2 heads of 16,
depth 2, 64 prototypes, fp32), the library flash attention in interpret
mode: from the same state (student ≠ teacher, non-zero centres) and the same
crops and masks, the loss and its parts, every student gradient, the teacher
after the EMA and both centres. The optimizer update is held separately, on
identical gradients (Adam turns rounding-level gradient differences into
sign flips, so post-Adam parameters of two implementations are never
compared). Also the schedules, the sampler, the SSL state bridge, the FLOP
count, and the entry points `pretrain` and `bench_ssl` on the CPU."""

import ast
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.data.samplers import ShardedInfiniteSampler as JaxSampler
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu.parallel.mesh import get_mesh
from adaptersis_tpu.ssl.masking import MaskInfo as JaxMaskInfo
from adaptersis_tpu.ssl.masking import MaskingGenerator as JaxMaskingGenerator
from adaptersis_tpu.ssl.masking import collate_masks_with_indices as jax_collate
from adaptersis_tpu.ssl.meta_arch import SSLConfig as JaxSSLConfig, SSLMetaArch as JaxSSLMetaArch
from adaptersis_tpu.train.schedules import cosine_scheduler as jax_cosine_scheduler
from adaptersis_tpu_torch import bench_ssl, pretrain
from adaptersis_tpu_torch.data.samplers import ShardedInfiniteSampler
from adaptersis_tpu_torch.models.layers import TRAINED
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.ssl.masking import MaskingGenerator, collate_masks_with_indices
from adaptersis_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch, masks_to
from adaptersis_tpu_torch.train.convert import load_ssl_state, seeded_init_, state_dict_to_flax
from adaptersis_tpu_torch.train.schedules import cosine_scheduler
from adaptersis_tpu_torch.utils.flops import ssl_step_flops
from torch_parity import init_perturbed, interpret_library_flash

ROOT = Path(__file__).resolve().parents[1]
SSL_IMPLS = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
VIT = dict(img_size=56, patch_size=14, embed_dim=32, depth=2, num_heads=2)
HEADS = dict(dino_out_dim=64, ibot_out_dim=64, head_hidden_dim=48, head_bottleneck_dim=16,
             n_local_crops=4)
B = 4                      # source images: 8 global crops, 16 local crops (2 per packed row)


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _inputs():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((2 * B, 56, 56, 3)).astype(np.float32)
    l = rng.standard_normal((4 * B, 28, 28, 3)).astype(np.float32)
    info = collate_masks_with_indices(2 * B, 16, MaskingGenerator((4, 4), num_masking_patches=8),
                                      seed=11)
    return g, l, info


def _state(jarch):
    """The tree of init_state, drawn by `perturb` from the shapes alone:
    student and teacher apart, non-zero centres, so the EMA and the
    centring are not vacuous; Adam's state and the step at zero."""
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
def step():
    """One step of each implementation from the same state, with lr = 0 so
    the new student is the old one and the EMA compares like with like.
    The JAX step's gradients come out of its Adam state: after one step
    mu = (1 − β1)·g."""
    g, l, info = _inputs()
    sched = {k: np.full(2, v, np.float64) for k, v in
             (("lr", 0.0), ("wd", 0.04), ("momentum", 0.9), ("teacher_temp", 0.05),
              ("last_layer_lr", 0.0))}
    with interpret_library_flash():
        jarch = JaxSSLMetaArch(JaxViT(attn_impl="flash", **VIT), JaxSSLConfig(**HEADS),
                               mesh=get_mesh(devices=jax.devices()[:1]))
        state = _state(jarch)
        jinfo = JaxMaskInfo(*map(jnp.asarray, info))
        new, metrics = jarch.train_step(jax.device_put(state), jnp.asarray(g), jnp.asarray(l),
                                        jinfo, sched, 0)
        new = jax.device_get(new)
    jgrads = jax.tree_util.tree_map(lambda m: m / (1 - 0.9), new["opt_state"].mu)

    arch = SSLMetaArch(DinoVisionTransformer(**SSL_IMPLS, **VIT), SSLConfig(**HEADS))
    load_ssl_state(arch, state)
    got = arch.train_step(torch.from_numpy(g), torch.from_numpy(l),
                          masks_to(info, torch.device("cpu")),
                          **{k: float(v[0]) for k, v in sched.items()})
    return state, new, {k: float(v) for k, v in metrics.items()}, jgrads, arch, got


def test_step_loss_and_parts(step):
    _, _, want, _, _, got = step
    assert set(got) == set(want)
    for k, v in want.items():
        # fp32 through two blocks, the heads and the losses on both sides
        assert abs(float(got[k]) - v) <= 1e-5 * max(1.0, abs(v)), (k, float(got[k]), v)
    assert want["ibot"] > 0 and want["koleo"] != 0


def test_step_student_gradients(step):
    _, _, _, jgrads, arch, _ = step
    want = _leaves(jgrads)
    got = _leaves(state_dict_to_flax({k: p.grad for k, p in
                                      arch.student.named_parameters()})["params"])
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for path, g in want.items():
        # fp32 sums in other orders through the 64-wide heads' softmaxes and
        # the flax LayerNorm's E[x²] − E[x]² variance: 1e-4 of each leaf's
        # largest gradient (≥ 1e-4 of the step's largest)
        scale = max(np.abs(g).max(), 1e-4 * top)
        np.testing.assert_allclose(got[path], g, atol=1e-4 * scale, rtol=0, err_msg=path)
        assert np.abs(got[path]).max() > 0, f"{path} got no gradient"


def test_step_teacher_ema_and_centres(step):
    state, new, _, _, arch, _ = step
    flax = state_dict_to_flax(arch)["params"]
    # lr = 0: the student is unchanged on both sides; t = 0.9·t + 0.1·s
    for tree in ("student", "teacher"):
        want, got = _leaves(new[tree]), _leaves(flax[tree])
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=1e-6 * max(1.0, np.abs(w).max()),
                                       rtol=0, err_msg=f"{tree}/{path}")
    moved = _leaves(state["teacher"])
    assert any(not np.allclose(moved[k], v) for k, v in _leaves(new["teacher"]).items())
    for c in ("dino_center", "ibot_center"):
        np.testing.assert_allclose(flax[c], np.asarray(new[c]), atol=1e-6, rtol=1e-5)
        assert not np.allclose(np.asarray(new[c]), state[c])
    assert arch.step == int(new["opt_state"].count) == 1


def test_optimizer_update_on_identical_gradients():
    """Adam's moments and the decoupled update p − lr·m·u − lr·m·wd·p (the
    JAX step's formula, with optax's scale_by_adam, its lr multipliers and
    weight-decay mask), then the teacher's EMA toward the new student, over
    two steps from the same parameters and the same gradients."""
    arch = SSLMetaArch(DinoVisionTransformer(**SSL_IMPLS, **VIT), SSLConfig(**HEADS))
    seeded_init_(arch, 4)
    jarch = JaxSSLMetaArch(JaxViT(attn_impl="flash", **VIT), JaxSSLConfig(**HEADS),
                           mesh=get_mesh(devices=jax.devices()[:1]))
    params = state_dict_to_flax(arch.student)["params"]
    teacher = state_dict_to_flax(arch.teacher)["params"]
    tx = optax.scale_by_adam(b1=0.9, b2=0.999)
    mults, wd_mask = jarch.lr_multipliers(params), jarch.wd_mask(params)

    @jax.jit
    def jax_update(params, teacher, opt, grads, lr, wd, llr, mom):
        updates, opt = tx.update(grads, opt, params)

        def apply(path, p, u, m, decay):     # meta_arch.py's apply_upd
            name = "/".join(str(k.key) for k in path)
            eff = (llr if "last_layer" in name else lr) * m
            return p - eff * u - jnp.where(decay, eff * wd, 0.0) * p

        params = jax.tree_util.tree_map_with_path(apply, params, updates, mults, wd_mask)
        teacher = jax.tree_util.tree_map(lambda t_, s: t_ * mom + s * (1 - mom), teacher, params)
        return params, teacher, opt

    opt = tx.init(params)
    rng = np.random.default_rng(5)
    for it, (lr, wd, llr, mom) in enumerate(((1e-3, 0.04, 2e-3, 0.9), (5e-4, 0.1, 1e-3, 0.99))):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape)
                       * 10.0 ** rng.uniform(-6, 0)).astype(np.float32), params)
        params, teacher, opt = jax_update(params, teacher, opt, grads,
                                          *map(jnp.float32, (lr, wd, llr, mom)))
        for name, p in arch.student.named_parameters():
            p.grad = torch.from_numpy(_torch_named(grads)[name])
        arch.optimizer_step(lr, wd, llr)
        arch.update_teacher(mom)
        for tree, want in (("student", params), ("teacher", teacher)):
            got = _leaves(state_dict_to_flax(getattr(arch, tree))["params"])
            for path, w in _leaves(want).items():
                # the same fp32 arithmetic in other orders: a few ulps
                np.testing.assert_allclose(got[path], np.asarray(w), rtol=1e-6, atol=1e-7,
                                           err_msg=f"step {it} {tree}/{path}")


def _torch_named(tree):
    """A flax-layout tree of gradients, by the port's parameter names."""
    from adaptersis_tpu_torch.train.convert import flax_to_state_dict
    return {k: v.numpy().copy() for k, v in flax_to_state_dict(tree, {}).items()}


def test_ssl_state_round_trip():
    """init_state's tree loads strictly and comes back unchanged from
    state_dict_to_flax."""
    jarch = JaxSSLMetaArch(JaxViT(attn_impl="flash", **VIT), JaxSSLConfig(**HEADS),
                           mesh=get_mesh(devices=jax.devices()[:1]))
    state = _state(jarch)
    arch = SSLMetaArch(DinoVisionTransformer(**SSL_IMPLS, **VIT), SSLConfig(**HEADS))
    load_ssl_state(arch, state)
    back = state_dict_to_flax(arch)
    assert back["batch_stats"] == {}
    want = _leaves({k: state[k] for k in ("student", "teacher", "dino_center", "ibot_center")})
    got = _leaves(back["params"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert arch.step == 0
    with pytest.raises(KeyError):
        load_ssl_state(arch, {**state, "teacher": {"backbone": state["teacher"]["backbone"]}})


def test_schedules_and_sampler_match():
    for args in ((4e-3, 1e-6, 3, 5, 1), (0.04, 0.4, 2, 7, 0), (4e-3, 1e-6, 4, 3, 1, 0.0, 5)):
        np.testing.assert_array_equal(cosine_scheduler(*args), jax_cosine_scheduler(*args))
    for kw in (dict(size=10, seed=3), dict(size=11, seed=0, advance=27),
               dict(size=12, seed=1, rank=1, world_size=2, advance=5),
               dict(size=9, shuffle=False, advance=4)):
        a, b = iter(ShardedInfiniteSampler(**kw)), iter(JaxSampler(**kw))
        assert [next(a) for _ in range(40)] == [next(b) for _ in range(40)]


def _jax_tool_flops():
    """`ssl_step_flops` of tools/bench_ssl_step.py, executed from its source
    (importing the tool would reconfigure jax's compilation cache)."""
    src = (ROOT / "tools" / "bench_ssl_step.py").read_text()
    keep = [n for n in ast.parse(src).body
            if (isinstance(n, ast.FunctionDef) and n.name == "ssl_step_flops")
            or (isinstance(n, ast.Assign) and any(getattr(t, "id", "") in ("_ARCH_DIMS",)
                                                  for t in n.targets))
            or (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Tuple))]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "bench_ssl_step", "exec"), ns)
    return ns["ssl_step_flops"]


@pytest.mark.parametrize("arch,E,depth", [("vit_small", 384, 12), ("vit_large", 1024, 24)])
def test_ssl_step_flops_match_the_jax_tool(arch, E, depth):
    ub = jax_collate(64, 256, JaxMaskingGenerator((16, 16), 128), seed=7).indices.shape[0]
    assert ssl_step_flops(32, E, depth, ub) == pytest.approx(_jax_tool_flops()(32, arch, ub),
                                                             rel=1e-12)


TINY = ["--device", "cpu", "--arch", "vit_test"]


def test_pretrain_entry_point_on_cpu(capsys):
    argv = TINY + ["--global_crops_size", "28", "--local_crops_size", "14",
                   "--local_crops_number", "2", "--batch_size_per_gpu", "2",
                   "--dino_out_dim", "64", "--epochs", "2", "--steps_per_epoch", "2",
                   "--warmup_epochs", "0", "--synthetic"]
    arch, hist = pretrain.run(pretrain.get_args_parser().parse_args(argv))
    assert [h["epoch"] for h in hist] == [0, 1] and arch.step == 4
    for h in hist:
        assert all(np.isfinite(h[k]) for k in ("total_loss", "dino", "ibot", "koleo", "img_per_s"))
    # the last layer is frozen for the first epoch, then trains
    start = pretrain.build_arch(pretrain.get_args_parser().parse_args(argv))
    assert not torch.equal(start.student["dino_head"].last_layer_v,
                           arch.student["dino_head"].last_layer_v)
    assert "sqrt scaling learning rate" in capsys.readouterr().out
    help_text = " ".join(pretrain.get_args_parser().format_help().split())
    assert "trains on synthetic frames" in help_text and "resumed from" in help_text
    for bad, says in ((["--fsdp", "2"], "does not divide the world size 1"),
                      (["--data_path", "/data"], "not ported")):
        with pytest.raises(SystemExit, match=says):
            pretrain.main(argv + bad)


def test_pretrain_freezes_the_last_layer():
    argv = TINY + ["--global_crops_size", "28", "--local_crops_size", "14",
                   "--local_crops_number", "2", "--batch_size_per_gpu", "2",
                   "--dino_out_dim", "64", "--epochs", "2", "--steps_per_epoch", "1",
                   "--warmup_epochs", "0", "--freeze_last_layer_epochs", "2"]
    arch, _ = pretrain.run(pretrain.get_args_parser().parse_args(argv))
    start = pretrain.build_arch(pretrain.get_args_parser().parse_args(argv))
    for name, p in arch.student.named_parameters():
        same = torch.equal(p, dict(start.student.named_parameters())[name])
        assert same == ("last_layer" in name), name


def test_bench_ssl_entry_point_on_cpu():
    res = bench_ssl.main(TINY + ["--batch", "2", "--global_size", "28", "--local_size", "14",
                                 "--n_local", "2", "--out_dim", "64", "--steps", "1",
                                 "--repeats", "1"])
    assert res["metric"] == "vit_test_dino_ibot_multicrop_train_images_per_sec_per_gpu"
    assert res["value"] > 0 and np.isfinite(res["loss"]) and res["batch"] == 2
    assert res["mfu"] is None and res["device"] == "cpu"
