"""The port's data-parallel layer (`adaptersis_tpu_torch/parallel/`): the
environment forms `init_distributed` reads (torchrun, SLURM, a tcp://
rendezvous), the mesh's divisibility rule, the SLURM launcher's sbatch
text, and the global-batch BatchNorm at two gloo ranks against the JAX
global-batch BatchNorm (flax's, as the JAX package's modules use it): the
output, the input gradient, the parameter gradients and the running
statistics with the biased variance; and the MetricLogger's counts and
totals summed over the ranks."""

import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from adaptersis_tpu_torch.parallel import dist as pdist
from adaptersis_tpu_torch.parallel import launch
from adaptersis_tpu_torch.parallel.mesh import get_mesh
from torch_dist import rows, spawn

TORCHRUN = {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
            "MASTER_PORT": "1"}
SLURM = {"SLURM_PROCID": "5", "SLURM_NTASKS": "16", "SLURM_LOCALID": "5",
         "MASTER_ADDR": "node7", "MASTER_PORT": "29500"}


@pytest.mark.parametrize("env, dist_url, local_rank, want", [
    (TORCHRUN, "env://", 0, pdist.Ranks(3, 8, 1, "env://")),
    # torchrun's variables win over SLURM's, as in the reference
    ({**SLURM, **TORCHRUN}, "env://", 0, pdist.Ranks(3, 8, 1, "env://")),
    (SLURM, "env://", 0, pdist.Ranks(5, 16, 5, "tcp://node7:29500")),
    ({"WORLD_SIZE": "2"}, "tcp://10.0.0.1:23456", 1,
     pdist.Ranks(1, 2, 1, "tcp://10.0.0.1:23456")),
    # one process launched alone, and a one-task SLURM job: no group
    ({}, "env://", 0, None),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, "env://", 0, None),
    ({}, "tcp://10.0.0.1:23456", 0, None),
])
def test_ranks_from_env(env, dist_url, local_rank, want):
    assert pdist.ranks_from_env(env, dist_url, local_rank) == want


def test_slurm_without_a_rendezvous_raises():
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        pdist.ranks_from_env({"SLURM_PROCID": "0", "SLURM_NTASKS": "2"})


def test_single_process_stays_uninitialised():
    assert pdist.init_distributed("env://", "cpu") == torch.device("cpu")
    assert (pdist.get_rank(), pdist.get_world_size(), pdist.is_main_process()) == (0, 1, True)
    assert get_mesh(1, "cpu") is None
    with pytest.raises(ValueError, match="not divisible"):
        get_mesh(2, "cpu")


def test_sbatch_runs_one_task_per_gpu(tmp_path, monkeypatch):
    path = launch.write_sbatch(str(tmp_path / "job.sh"),
                               ["-m", "adaptersis_tpu_torch.train_seg", "--fsdp", "2"],
                               nodes=2, gpus_per_node=4, port=29555)
    text = open(path).read()
    for line in ("#SBATCH --nodes=2", "#SBATCH --ntasks-per-node=4",
                 "#SBATCH --gpus-per-node=4", "#SBATCH --requeue", "export MASTER_PORT=29555"):
        assert line in text.splitlines(), line
    assert "MASTER_ADDR=$(scontrol show hostnames" in text
    assert text.rstrip().endswith("-m adaptersis_tpu_torch.train_seg --fsdp 2")
    assert "srun --unbuffered" in text
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    assert launch.detect_cluster() == "local"
    monkeypatch.setenv("SLURM_JOB_ID", "42")
    assert launch.detect_cluster() == "slurm"


N, C, H, W = 6, 5, 3, 4


@pytest.fixture(scope="module")
def bn_run(tmp_path_factory):
    """The "bn" job at two ranks: the global BatchNorm on rows r, r + 2,
    r + 4 of a seeded global batch of 6, then a MetricLogger's sync."""
    d = tmp_path_factory.mktemp("bn")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((N, C, H, W)) * 2.0 + 0.5).astype(np.float32)
    w = rng.standard_normal((N, C, H, W)).astype(np.float32)
    state = {"weight": rng.uniform(0.5, 1.5, C), "bias": rng.standard_normal(C),
             "running_mean": rng.standard_normal(C), "running_var": rng.uniform(0.5, 2.0, C),
             "num_batches_tracked": np.int64(0)}
    state = {k: torch.tensor(v, dtype=torch.float32 if k != "num_batches_tracked" else None)
             for k, v in state.items()}
    torch.save({"x": torch.from_numpy(x), "w": torch.from_numpy(w), "state": state},
               d / "bn_in.pt")
    spawn("bn", d, timeout=60)
    return d, x, w, state, [torch.load(d / f"bn.out{r}.pt") for r in range(2)]


def test_global_batchnorm_matches_jax(bn_run):
    """Two ranks of 3 rows each against flax's BatchNorm on all 6, under a
    loss Σ y·w. The input gradient of each row and the running statistics
    match; each rank's parameter gradient is its rows' share, and the two
    shares sum to the global one (the trainer averages them over the
    ranks, each rank's loss being the mean over its rows)."""
    _, x, w, state, outs = bn_run
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(state["weight"].numpy()),
                            "bias": jnp.asarray(state["bias"].numpy())},
                 "batch_stats": {"mean": jnp.asarray(state["running_mean"].numpy()),
                                 "var": jnp.asarray(state["running_var"].numpy())}}
    xh, wh = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(0, 2, 3, 1))

    def loss(params, xh):
        y, mut = bn.apply({**variables, "params": params}, xh, mutable=["batch_stats"])
        return (y * wh).sum(), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], xh)
    y, gx = np.asarray(y).transpose(0, 3, 1, 2), np.asarray(gx).transpose(0, 3, 1, 2)
    for r, out in enumerate(outs):
        mine = rows(N, r, 2)
        # fp32 sums of 36 values in other orders on both sides
        np.testing.assert_allclose(out["y"].numpy(), y[mine], atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["dx"].numpy(), gx[mine], atol=1e-5, rtol=0)
        # flax: 0.9·old + 0.1·batch, the batch variance biased (÷ 72)
        np.testing.assert_allclose(out["running_mean"].numpy(), np.asarray(stats["mean"]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(out["running_var"].numpy(), np.asarray(stats["var"]),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(sum(o["dweight"].numpy() for o in outs), np.asarray(gp["scale"]),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(sum(o["dbias"].numpy() for o in outs), np.asarray(gp["bias"]),
                               atol=1e-4, rtol=1e-5)
    biased = x.reshape(N, C, -1).transpose(1, 0, 2).reshape(C, -1).var(axis=1)
    want = 0.9 * state["running_var"].numpy() + 0.1 * biased
    np.testing.assert_allclose(outs[0]["running_var"].numpy(), want, rtol=1e-5)


def test_metric_logger_sums_over_ranks(bn_run):
    """Rank r logs r + 2 values v = 10·r + i with weights i + 1: after the
    synchronisation every rank's count and total are the job's, in float64;
    only rank 0 writes the output file."""
    d, *_, outs = bn_run
    count = sum(i + 1 for r in range(2) for i in range(r + 2))
    total = sum((10.0 * r + i) * (i + 1) for r in range(2) for i in range(r + 2))
    for out in outs:
        assert out["loss_meter"] == (count, total, total / count)
    lines = (d / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["loss"] == 0.5


def test_each_rank_augments_its_rows_of_the_global_batch(monkeypatch):
    """At W ranks of B images each, rank r's j-th image of a step is image
    j·W + r of the one-process step at batch W·B (the sampler's slice), and
    its draws are that image's row of the draws made for the global batch:
    the step sees the images and augmentations a single process would."""
    from adaptersis_tpu_torch.data import augment
    from adaptersis_tpu_torch.data.samplers import EpochSampler

    W, B, S = 2, 3, 16
    one = list(EpochSampler(24, seed=5))
    want = augment.draw_train_augment(torch.Generator().manual_seed(9), W * B, S)
    for r in range(W):
        shard = list(EpochSampler(24, seed=5, rank=r, world_size=W))
        for step in range(len(shard) // B):
            assert shard[step * B:(step + 1) * B] == one[step * W * B:(step + 1) * W * B][r::W]
        monkeypatch.setattr(augment, "get_rank", lambda: r)
        monkeypatch.setattr(augment, "get_world_size", lambda: W)
        got = augment.rank_rows(augment.draw_train_augment(torch.Generator().manual_seed(9),
                                                           W * B, S))
        for k, v in want.items():
            assert torch.equal(got[k], v[r::W]), k
