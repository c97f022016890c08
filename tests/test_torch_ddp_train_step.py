"""The port's data-parallel segmentation training at two gloo ranks against
the JAX package: one adapter train step (vit_test width, 4 blocks, 56 px,
a global batch of 4 split 2 + 2) at --fsdp 1 and 2 against the JAX step on
a 2-device mesh (the batch sharded over "data"), both in float64 as in
`segmentor_parity.run`: the loss, the BatchNorm statistics, every
trainable's gradient and its value after the SGD step. Then the
checkpoint across world sizes (train_seg at W = 2, --fsdp 2, stopped after
an epoch and resumed at W = 1 on the same global batch; a tap_setr_ete
state, whose trained backbone and momentum are sharded, written at W = 2
and read at W = 1 and the other way), and the all-reduced validation
metrics against the single-process ones on 5 images over 2 ranks."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from adaptersis_tpu.losses import LOSSES
from adaptersis_tpu.models.segmentor import AdapterSegmentor as JaxSegmentor
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu.parallel.mesh import get_mesh
from adaptersis_tpu.train.trainer import Trainer as JaxTrainer, TrainerConfig
from adaptersis_tpu_torch import evaluate, train_seg
from adaptersis_tpu_torch.models.layers import TRAINED
from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.tap_segmentor import TapSegmentor
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.checkpoint import restore_checkpoint
from adaptersis_tpu_torch.train.convert import state_dict_to_flax
from adaptersis_tpu_torch.train.trainer import Trainer
from segmentor_parity import check_gradients, check_loss_and_stats, leaves
from torch_dist import start, wait
from torch_parity import init_perturbed, load, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

IMG, B = 56, 4
VIT = dict(img_size=56, patch_size=14, embed_dim=64, depth=4, num_heads=2)
HEAD = dict(num_classes=2, n_last_blocks=4, encoder_inplanes=16,
            decoder_features=(64, 32, 16, 16, 8))
LR, EPOCHS = 0.05, 4
CLI = ["--arch", "vit_test", "--patch_size", "14", "--imsize", "56", "--epochs", "2",
       "--synthetic", "--device", "cpu", "--num_workers", "1"]
VAL = ["--arch", "vit_test", "--patch_size", "14", "--imsize", "56", "--batch_size_per_gpu", "2",
       "--synthetic", "--val_images", "5", "--num_classes", "3", "--device", "cpu",
       "--num_workers", "1", "--seed", "3"]


def _batch():
    x = np.random.default_rng(4).integers(0, 256, (B, IMG, IMG, 3)) / 255.0
    y = (np.random.default_rng(5).uniform(size=(B, IMG, IMG)) > 0.7).astype(np.int32)
    return x, y


def _ete_trainer():
    torch.manual_seed(0)
    impls = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
    model = TapSegmentor(DinoVisionTransformer(gelu_approx=True, **impls, **VIT),
                         num_classes=2, decoder="setr_ete")
    return Trainer(model, lr=0.05, epochs=4, loss="ce_dc", softmax=False)


def _jax_step(variables, x, y):
    """The JAX package's train step on a 2-device mesh, in float64: the
    trainer's softmax → "dc" loss, its new statistics, its gradients, and
    `Trainer.tx`'s first update."""
    jmodel = JaxSegmentor(backbone=JaxViT(gelu_approx=True, dtype=jnp.float64, **VIT),
                          msda_impl="gather", dtype=jnp.float64, **HEAD)
    mesh = get_mesh(devices=jax.devices()[:2])
    data, rep = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    params = dict(variables["params"])
    frozen = {"backbone": params.pop("backbone")}
    tx = JaxTrainer(jmodel, TrainerConfig(lr=LR, epochs=EPOCHS), mesh=mesh).tx

    def loss_of(p, x, y):
        logits, mut = jmodel.apply({"params": {**p, **frozen},
                                    "batch_stats": variables["batch_stats"]},
                                   x, train=True, mutable=["batch_stats"])
        return LOSSES["dc"](jax.nn.softmax(logits, axis=-1), y), mut["batch_stats"]

    @jax.jit
    def step(p, x, y):
        (loss, stats), g = jax.value_and_grad(loss_of, has_aux=True)(p, x, y)
        updates, _ = tx.update(g, tx.init(p), p)
        new = jax.tree_util.tree_map(lambda a, u: a + LR * u, p, updates)
        return loss, stats, g, new

    loss, stats, g, new = step(jax.device_put(params, rep),
                               jax.device_put(jnp.asarray(x, jnp.float64), data),
                               jax.device_put(jnp.asarray(y), data))
    return float(loss), leaves(stats), leaves(g), leaves(new)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' jobs, started first; the JAX step and the single-process
    runs while they work."""
    d = tmp_path_factory.mktemp("ddp")
    x, y = _batch()
    with jax.enable_x64(True):
        jmodel32 = JaxSegmentor(backbone=JaxViT(gelu_approx=True, **VIT), msda_impl="gather",
                                **HEAD)
        variables = init_perturbed(jmodel32, 17, jnp.asarray(x, jnp.float32))
    model = load(AdapterSegmentor(DinoVisionTransformer(gelu_approx=True, **VIT), **HEAD),
                 variables).double()
    torch.save({"cfg": {"vit": VIT, "head": HEAD}, "state": model.state_dict(),
                "x": torch.from_numpy(x), "y": torch.from_numpy(y).long(), "lr": LR,
                "epochs": EPOCHS, "val_argv": VAL}, d / "step_in.pt")
    (d / "train_seg_argv.txt").write_text(" ".join(CLI + ["--batch_size_per_gpu", "2",
                                                          "--fsdp", "2"]))
    ete = _ete_trainer()
    ete.step(torch.from_numpy(x).float(), torch.from_numpy(y).long(), 0)
    torch.save(ete.state_dict(), d / "ete_w1.pt")
    torch.save({"vit": VIT, "x": torch.from_numpy(x).float(), "y": torch.from_numpy(y).long()},
               d / "ete_in.pt")
    jobs = {job: start(job, d) for job in ("step", "train_seg", "ete_state")}

    with jax.enable_x64(True):
        jax_out = _jax_step(variables, x, y)
    single = {"val": evaluate.main(VAL),
              # the same global batch in one process, from scratch
              "a1": train_seg.main(CLI + ["--batch_size_per_gpu", "4",
                                          "--output_dir", str(d / "a1")])}
    for job, procs in jobs.items():
        wait(procs, d, job, timeout=240)
    # the run stopped at W = 2 after one epoch, resumed here at W = 1
    single["resumed"] = train_seg.main(CLI + ["--batch_size_per_gpu", "4",
                                              "--output_dir", str(d / "stopped")])
    out = {job: [torch.load(d / f"{job}.out{r}.pt", weights_only=False) for r in range(2)]
           for job in jobs}
    return d, jax_out, out, single


def _flax(named):
    return leaves(state_dict_to_flax(named)["params"])


@pytest.mark.parametrize("fsdp", [1, 2])
def test_two_rank_step_matches_jax_mesh(runs, fsdp):
    _, (jloss, jstats, jgrads, jnew), out, _ = runs
    r0, r1 = out["step"][0][fsdp], out["step"][1][fsdp]
    assert r0["loss"] == r1["loss"]
    trained = {k for k in r0["state"] if not k.startswith("backbone.")}
    tstats = leaves(state_dict_to_flax({k: v for k, v in r0["state"].items()
                                        if k in trained})["batch_stats"])
    # the single-process bounds of segmentor_parity: float64 on both sides,
    # the all-reduced sums in another order only move the last bits
    check_loss_and_stats({"loss": (jloss, r0["loss"]), "stats": (jstats, tstats)})
    check_gradients({"grads": (jgrads, _flax(r0["grads"]))})
    for k in r0["grads"]:
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k      # one all-reduced buffer
    new = _flax({k: v for k, v in r0["state"].items() if k in dict(r0["grads"])})
    top = max(np.abs(g).max() for g in jgrads.values())
    for path, want in jnew.items():
        # one SGD step of lr · (g + wd·p): the gradient bound above, times
        # lr, and the fp32 rounding of the flax view (state_dict_to_flax)
        scale = max(np.abs(jgrads[path]).max(), 1e-3 * top)
        atol = LR * 1e-3 * scale + 2.0 ** -24 * np.abs(want).max()
        np.testing.assert_allclose(new[path], want, atol=atol, rtol=0, err_msg=path)


def test_frozen_backbone_is_the_same_under_fsdp(runs):
    _, _, out, _ = runs
    s1, s2 = out["step"][0][1]["state"], out["step"][0][2]["state"]
    for k, v in s1.items():
        if k.startswith("backbone."):
            assert torch.equal(s2[k], v), k


def test_validation_metrics_equal_single_process(runs):
    """5 images over 2 ranks: rank 1 pads its last batch with image 0, which
    the all-reduced sums leave out."""
    *_, out, single = runs
    want = single["val"]
    for r in range(2):
        got = out["step"][r]["val"]
        assert got["images"] == want["images"] == 5 and got["world_size"] == 2
        for k in ("loss", "dice", "acc1", "ch_iou", "isi_iou"):
            # per-image metrics in eval mode: the same images, summed in
            # another order (float64 sums of fp32 values)
            assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), (k, got[k], want[k])


def _distance(a, b):
    return {k: float((a[k].double() - b[k].double()).abs().max()) for k in a
            if torch.is_tensor(a[k]) and a[k].is_floating_point()}


def test_checkpoint_written_at_two_ranks_resumes_at_one(runs):
    """R: train_seg at W = 2, --fsdp 2, batch 2 a rank, stopped after epoch
    0 and resumed at W = 1 on batch 4 (the same global batches, images and
    augmentations) against A, the W = 2 run that never stopped. A′ is the
    W = 1 run from scratch: the two world sizes' fp32 sums differ, so R
    is held to the resume rule d(R, A) ≤ 2·d(A, A′) per tensor."""
    d, _, out, single = runs
    A = restore_checkpoint(d / "full")["model"]
    R = restore_checkpoint(d / "stopped")["model"]
    A1 = restore_checkpoint(d / "a1")["model"]
    assert set(R) == set(A) == set(A1)
    floor, dist = _distance(A, A1), _distance(R, A)
    for k, v in dist.items():
        assert v <= 2 * floor[k] + 1e-7, (k, v, floor[k])
    assert max(floor.values()) > 0
    logs = [json.loads(line) for line in (d / "stopped" / "log.txt").read_text().splitlines()]
    assert [e["epoch"] for e in logs] == [0, 1]
    assert out["train_seg"][0]["stopped"][0]["world_size"] == 2
    assert single["resumed"][0]["epoch"] == 1 and single["resumed"][0]["world_size"] == 1
    full = out["train_seg"][0]["full"]
    assert abs(logs[1]["train_loss"] - full[1]["train_loss"]) <= 1e-3


def test_sharded_state_crosses_world_sizes(runs):
    """tap_setr_ete at --fsdp 2: the whole state written at W = 2 reloads at
    W = 2 unchanged and at W = 1 unchanged; the W = 1 state reloads at
    W = 2 unchanged."""
    d, _, out, _ = runs
    r0 = out["ete_state"][0]
    saved, reloaded = r0["saved"], r0["reloaded"]
    w1 = torch.load(d / "ete_w1.pt")

    def same(a, b):
        assert set(a["model"]) == set(b["model"])
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), k
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        assert set(sa) == set(sb) and sa
        for i in sa:
            assert torch.equal(sa[i]["momentum_buffer"], sb[i]["momentum_buffer"]), i

    assert any(k.startswith("backbone.blocks.") for k in saved["model"])
    same(saved, reloaded)
    same(w1, r0["from_w1"])
    one = _ete_trainer()
    one.load_state_dict(saved)
    same(saved, one.state_dict())
