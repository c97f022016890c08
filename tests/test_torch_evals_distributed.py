"""The port's distributed k-NN and feature extraction at two gloo ranks
(`tests/torch_dist.py`'s `evals` job): `knn_classify` with the train rows
split over the ranks, their count odd so that the second rank's block is
padded, against the JAX sharded path on a 2-device mesh; and
`extract_features` over each rank's shard of the frames, gathered on every
rank, against one process (whose taps test_torch_evals.py holds against
the JAX package); and `all_gather_rows` with another row count on each
rank."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.evals import knn_classify as jax_knn
from adaptersis_tpu.parallel.mesh import get_mesh
from adaptersis_tpu_torch.evals import ModelWithIntermediateLayers, extract_features
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import seeded_init_
from test_torch_evals import KNN_TOL, VIT, blobs
from torch_dist import start, wait
from torch_parity import n, single_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

ATOL = 2e-5     # fp32, one process against two: the same arithmetic per image


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The ranks' job started first: knn_classify on 37 train rows (odd,
    so the second rank's block is padded) and extract_features over
    unshuffled shards of 7 frames (the second shard padded with a repeat);
    meanwhile the JAX sharded k-NN on 2 devices and the port's extraction
    in one process (held against the JAX taps by
    test_intermediate_layer_taps)."""
    d = tmp_path_factory.mktemp("evals")
    x, y = blobs(37, 16, 4, spread=2.0)
    xt, _ = blobs(21, 16, 4, seed=1, spread=2.0)
    frames = np.random.default_rng(5).integers(0, 256, (7, 56, 56, 3), np.uint8)
    labels = np.arange(7) % 3
    vit = DinoVisionTransformer(**VIT)
    seeded_init_(vit, 4)
    ks = (5, 10)
    torch.save({"train": t(x), "train_y": torch.from_numpy(y).long(), "test": t(xt),
                "classes": 4, "ks": ks, "chunk": 8, "vit": VIT, "state": vit.state_dict(),
                "imgs": frames, "labels": labels, "n_last_blocks": 2}, d / "evals_in.pt")
    procs = start("evals", d)
    mesh = get_mesh(devices=jax.devices()[:2])
    want = {k: np.asarray(jax_knn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), 4, k=k,
                                  mesh=mesh, test_chunk=8)) for k in ks}
    batches = [(frames[i:i + 3], labels[i:i + 3], np.arange(i, min(i + 3, 7)))
               for i in range(0, 7, 3)]
    want["features"], want["labels"] = (
        n(a) for a in extract_features(ModelWithIntermediateLayers(vit.eval(), 2), batches))
    wait(procs, d, "evals", timeout=120)
    return want, [torch.load(d / f"evals.out{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("k", [5, 10])
def test_knn_classify_two_ranks(two_ranks, k):
    want, got = two_ranks
    for rank in got:
        np.testing.assert_allclose(n(rank[k]), want[k], **KNN_TOL)


def test_extract_features_two_ranks(two_ranks):
    want, got = two_ranks
    for rank in got:
        assert rank["features"].shape == (7, 64)
        np.testing.assert_allclose(n(rank["features"]), want["features"], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(rank["labels"].numpy(), want["labels"])


def test_all_gather_rows_uneven_counts(two_ranks):
    _, got = two_ranks
    want = np.array([[0] * 3, [10] * 3, [11] * 3])
    for rank in got:
        np.testing.assert_array_equal(rank["uneven"].numpy(), want)
