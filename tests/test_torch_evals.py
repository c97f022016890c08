"""The port's frozen-feature evaluations (`adaptersis_tpu_torch/evals/`)
against the JAX package's on the same numpy-seeded inputs: the metrics;
`ModelWithIntermediateLayers`'s taps at vit_test width with the JAX
parameters carried across; `knn_classify` against the JAX dense path; the
linear-probe grid from the JAX grid's parameters over 5 SGD steps. Split
off to keep each file's time small: the two-rank k-NN and extraction
(test_torch_evals_distributed.py), the logistic-regression sweep
(test_torch_logreg.py), the CLI (test_torch_evals_cli.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.evals import LinearProbeGrid as JaxGrid
from adaptersis_tpu.evals import ModelWithIntermediateLayers as JaxTaps
from adaptersis_tpu.evals import knn_classify as jax_knn
from adaptersis_tpu.evals import metrics as jm
from adaptersis_tpu.models.vit import DinoVisionTransformer as JaxViT
from adaptersis_tpu_torch.evals import LinearProbeGrid, ModelWithIntermediateLayers, knn_classify
from adaptersis_tpu_torch.evals import metrics as tm
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import load_flax_variables, probe_grid_variables
from torch_parity import init_perturbed, load, n, single_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

VIT = dict(img_size=56, patch_size=14, embed_dim=64, depth=5, num_heads=4)
# fp32 on both sides, as test_torch_vit's backbone bound
ATOL = 2e-5


def blobs(n_rows, d, c, seed=0, spread=4.0, centers_seed=42):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(centers_seed).standard_normal((c, d)) * spread
    y = rng.integers(0, c, n_rows)
    x = centers[y] + rng.standard_normal((n_rows, d))
    return x.astype(np.float32), y.astype(np.int32)


# ---- metrics

@pytest.mark.parametrize("average", ["micro", "macro", "none"])
@pytest.mark.parametrize("k", [1, 3])
def test_topk_accuracy(k, average):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((40, 6)).astype(np.float32)
    logits[:5, 1] = logits[:5, 2]                        # ties: the lower class first
    y = rng.integers(0, 5, 40)                           # class 5 absent
    want = jm.topk_accuracy(jnp.asarray(logits), jnp.asarray(y), k=k, average=average)
    got = tm.topk_accuracy(t(logits), torch.from_numpy(y), k=k, average=average)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=0)


def test_real_accuracy_accumulator_and_build_metric():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, 6)).astype(np.float32)      # test_topk_accuracy's shapes
    targets = (rng.uniform(size=(40, 6)) < 0.3).astype(np.int32)
    targets[:4] = 0                                       # no targets: left out
    assert float(tm.real_accuracy(t(logits), torch.from_numpy(targets))) == pytest.approx(
        float(jm.real_accuracy(jnp.asarray(logits), jnp.asarray(targets))), abs=1e-7)
    y = rng.integers(0, 5, 40)
    for kind in ("mean_accuracy", "mean_per_class_accuracy", "per_class_accuracy"):
        want, got = jm.build_metric(kind), tm.build_metric(kind)
        assert list(want) == list(got) == ["top-1", "top-5"]
        for name in want:
            np.testing.assert_allclose(n(got[name](t(logits), torch.from_numpy(y))),
                                       np.asarray(want[name](jnp.asarray(logits),
                                                             jnp.asarray(y))), atol=1e-7)
    a, b = jm.MetricAccumulator(), tm.MetricAccumulator()
    for hits, count in ((0.5, 4), (1.0, 2), (0.25, 8)):
        a.update(jnp.asarray(hits), count)
        b.update(torch.tensor(hits), count)
    assert (a.correct, a.count, a.value) == (b.correct, b.count, b.value)


# ---- feature taps

def test_intermediate_layer_taps():
    x = np.random.default_rng(1).uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    jvit = JaxViT(**VIT)
    variables = init_perturbed(jvit, 3, jnp.asarray(x))
    want = JaxTaps(jvit, variables, n_last_blocks=4)(jnp.asarray(x))
    model = ModelWithIntermediateLayers(load(DinoVisionTransformer(**VIT), variables), 4)
    got = model(t(x))
    assert len(got) == 4
    for (wp, wc), (gp, gc) in zip(want, got):
        assert gp.shape == (2, 16, 64) and gc.shape == (2, 64) and not gp.requires_grad
        np.testing.assert_allclose(n(gp), np.asarray(wp), atol=ATOL, rtol=0)
        np.testing.assert_allclose(n(gc), np.asarray(wc), atol=ATOL, rtol=0)


# ---- k-NN

KNN_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_evals.py's dense-vs-sharded bound


@pytest.mark.parametrize("chunk", [1024, 16])
def test_knn_classify_dense(chunk):
    x, y = blobs(256, 16, 4)
    xt, _ = blobs(40, 16, 4, seed=1)
    for k in (5, 10):
        want = jax_knn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), 4, k=k,
                       test_chunk=chunk)
        got = knn_classify(t(x), torch.from_numpy(y), t(xt), 4, k=k, test_chunk=chunk)
        np.testing.assert_allclose(n(got), np.asarray(want), **KNN_TOL)


# ---- linear-probe grid

def test_linear_probe_grid_steps():
    E, blocks, C, B = 16, 2, 3, 24
    rng = np.random.default_rng(6)
    taps_np = [(rng.standard_normal((B, 4, E)).astype(np.float32),
                rng.standard_normal((B, E)).astype(np.float32)) for _ in range(blocks)]
    ys = [rng.integers(0, C, B) for _ in range(5)]
    grid = LinearProbeGrid(embed_dim=E, n_last_blocks=blocks, num_classes=C)
    assert [h.name for h in grid.specs] == [h.name for h in JaxGrid(E, blocks, C).heads]
    assert len(grid.specs) == 2 * 2 * 13
    # trained on a grid of one learning rate (4 heads: both tap counts, with
    # and without the pooled patch token): the JAX step's compile grows with
    # the heads
    lrs = (0.5,)
    jgrid = JaxGrid(embed_dim=E, n_last_blocks=blocks, num_classes=C, lrs=lrs)
    jgrid.init(jax.random.PRNGKey(0))
    grid = LinearProbeGrid(embed_dim=E, n_last_blocks=blocks, num_classes=C, lrs=lrs)
    load_flax_variables(grid, probe_grid_variables(jax.device_get(jgrid.params)), {})
    jtaps = tuple((jnp.asarray(p), jnp.asarray(c)) for p, c in taps_np)
    taps = tuple((t(p), t(c)) for p, c in taps_np)
    for y in ys:
        want = jgrid.train_step(jtaps, jnp.asarray(y))
        got = grid.train_step(taps, torch.from_numpy(y))
        for name, v in want.items():
            assert got[name] == pytest.approx(v, rel=1e-5, abs=1e-6), name
    for name, p in jax.device_get(jgrid.params).items():
        np.testing.assert_allclose(n(grid.heads[name].weight).T, p["w"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(n(grid.heads[name].bias), p["b"], rtol=1e-4, atol=1e-6)
    yv = [rng.integers(0, C, B)]
    want_best, want_accs = jgrid.evaluate([jtaps], yv)
    best, accs = grid.evaluate([taps], [torch.from_numpy(yv[0])])
    assert (best, accs) == (want_best, pytest.approx(want_accs, abs=1e-9))
