"""The port's `hub` against the JAX package's: the same URL tables and names,
and from one seeded `.pth` and one seeded linear-head file (written under
`tmp_path`) the same `_lc` features and logits for layers 1 and 4, each
package through its own loaders, fp32 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adaptersis_tpu import hub as jhub
from adaptersis_tpu_torch import hub
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from torch_parity import dinov2_state_dict, n, single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

ARCH = "vit_test"         # 64 wide, 5 blocks, 4 heads: in both packages' ARCHS
VIT = dict(img_size=518, patch_size=14, embed_dim=64, depth=5, num_heads=4)
CLASSES = 10
# fp32 on both sides (test_torch_vit's tolerance), of the output's scale
ATOL = 2e-5


@pytest.fixture
def files(tmp_path):
    """A seeded backbone `.pth` in a DINOv2 training checkpoint's layout and
    a seeded linear head ({weight, bias}) for layers 1 and 4."""
    torch.save({"teacher": {f"backbone.{k}": v for k, v in dinov2_state_dict(VIT, 2).items()}},
               tmp_path / "backbone.pth")
    rng = np.random.default_rng(3)
    for layers in (1, 4):
        d = (1 + layers) * 64
        torch.save({"weight": torch.from_numpy((rng.standard_normal((CLASSES, d))
                                                / np.sqrt(d)).astype(np.float32)),
                    "bias": torch.from_numpy(0.1 * rng.standard_normal(CLASSES)
                                             .astype(np.float32))},
                   tmp_path / f"head{layers}.pth")
    return tmp_path


def test_tables_are_the_jax_packages():
    assert hub.DINOV2_URLS == jhub.DINOV2_URLS
    assert hub.DINOV1_URLS == jhub.DINOV1_URLS
    assert hub._NAME2ARCH == jhub._NAME2ARCH


@pytest.mark.parametrize("layers", [1, 4])
@pytest.mark.parametrize("what", ["features", "logits"])
def test_linear_classifier_matches_jax(files, layers, what):
    x = np.random.default_rng(layers).uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    pth, head_pth = str(files / "backbone.pth"), str(files / f"head{layers}.pth")
    jmodel, params = jhub.build_model_for_eval(ARCH, pth)
    model = hub.build_model_for_eval(ARCH, pth, device="cpu")
    if what == "features":
        want = jhub.linear_classifier_features(jmodel, params, jnp.asarray(x), layers)
        got = hub.linear_classifier_features(model, torch.from_numpy(x), layers)
        assert got.shape == (2, (1 + layers) * 64)
    else:
        jhead = jhub.load_linear_head_params(head_pth, expect_in=(1 + layers) * 64)
        want = jhub.linear_classifier_logits(jmodel, params, jhead, jnp.asarray(x), layers)
        head = hub.load_linear_head_params(head_pth, expect_in=(1 + layers) * 64)
        assert isinstance(head, torch.nn.Linear)
        got = hub.linear_classifier_logits(model, head, torch.from_numpy(x), layers)
        assert got.shape == (2, CLASSES)
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, atol=ATOL * max(1.0, np.abs(want).max()), rtol=0)


def test_build_model_for_eval(files):
    """The `.pth` loads strictly; without one the draw is seeded; the card
    is the default and its absence raises."""
    sd = dinov2_state_dict(VIT, 2)
    model = hub.build_model_for_eval(ARCH, str(files / "backbone.pth"), device="cpu")
    assert isinstance(model, DinoVisionTransformer) and not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    a, b = (hub.build_model_for_eval(ARCH, device="cpu") for _ in range(2))
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hub.build_model_for_eval(ARCH)
    with pytest.raises(ValueError, match="Unsupported number of layers"):
        hub.linear_classifier_features(model, torch.zeros(1, 28, 28, 3), layers=2)
    with pytest.raises(ValueError, match="in-dim"):
        hub.load_linear_head_params(str(files / "head1.pth"), expect_in=64)
