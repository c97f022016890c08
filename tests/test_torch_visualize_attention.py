"""`python -m adaptersis_tpu_torch.visualize_attention --device cpu` against
the JAX package's `tools/visualize_attention.py`: the same flags (plus
`--device`), the last block's attention probabilities from a seeded `.pth`
within 1e-6 of the JAX backbone's, each row summing to 1, and 2 × heads
PNGs at the image's size: the per-head maps and the threshold masks."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from adaptersis_tpu.models.vit import build_backbone as jax_build_backbone
from adaptersis_tpu.train.convert import load_dinov2_backbone_params
from adaptersis_tpu_torch import visualize_attention
from torch_parity import dinov2_state_dict, n, single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(img_size=518, patch_size=14, embed_dim=64, depth=5, num_heads=4)   # vit_test
SIZE = 56


def _tool_parser():
    """The JAX tool's parser, read from its source (its main() parses and runs)."""
    spec = importlib.util.spec_from_file_location(
        "repo_visualize_attention", os.path.join(ROOT, "tools", "visualize_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


def test_flags_are_the_tools_plus_device(monkeypatch):
    captured = {}

    def parse(self, args=None, namespace=None):
        captured.update(_options(self))
        raise SystemExit(0)

    monkeypatch.setattr("argparse.ArgumentParser.parse_args", parse)
    with pytest.raises(SystemExit):
        _tool_parser().main()
    mine = _options(visualize_attention.get_args_parser())
    assert set(mine) - set(captured) == {"--device"} and set(captured) <= set(mine)
    for opt, a in captured.items():
        b = mine[opt]
        assert (b.dest, b.default, b.nargs, b.type) == (a.dest, a.default, a.nargs, a.type), opt
    assert mine["--device"].default == "cuda"


@pytest.mark.parametrize("weights", [True, False])
def test_maps_on_the_cpu(tmp_path, weights):
    pth = tmp_path / "vit.pth"
    if weights:
        torch.save({"teacher": dinov2_state_dict(VIT, 9)}, pth)
    out = tmp_path / "maps"
    argv = ["--arch", "vit_test", "--patch_size", "14", "--image_size", str(SIZE),
            "--output_dir", str(out), "--device", "cpu", "--threshold", "0.5"]
    attn, paths = visualize_attention.run(visualize_attention.get_args_parser().parse_args(
        argv + (["--pretrained_weights", str(pth)] if weights else [])))
    heads, N = 4, (SIZE // 14) ** 2 + 1
    assert attn.dtype == torch.float32 and tuple(attn.shape) == (heads, N, N)
    np.testing.assert_allclose(n(attn.sum(-1)), 1.0, atol=1e-5)
    assert sorted(os.listdir(out)) == sorted(
        [f"attn-head{j}.png" for j in range(heads)]
        + [f"mask_th0.5_head{j}.png" for j in range(heads)])
    assert sorted(paths) == sorted(str(out / f) for f in os.listdir(out))
    for p in paths:
        assert np.asarray(Image.open(p)).shape == (SIZE, SIZE)
    masks = [np.asarray(Image.open(out / f"mask_th0.5_head{j}.png")) for j in range(heads)]
    assert all(set(np.unique(m)) <= {0, 255} and m.max() == 255 for m in masks)
    if weights:
        # the JAX backbone on the same image (the tool's seeded noise)
        x = np.random.default_rng(0).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
        jmodel = jax_build_backbone("vit_test", img_size=518, patch_size=14)
        want = jmodel.apply({"params": load_dinov2_backbone_params(str(pth))},
                            jnp.asarray(x)[None], method=jmodel.get_last_selfattention)
        np.testing.assert_allclose(n(attn), np.asarray(want)[0], atol=1e-6, rtol=0)


def test_mass_masks_keep_the_threshold():
    """Each head's mask holds the fewest largest patches whose attention
    reaches the threshold of its mass."""
    a = np.array([[[0.5, 0.3], [0.15, 0.05]]], np.float32)
    np.testing.assert_array_equal(visualize_attention.mass_masks(a, 0.6),
                                  [[[1, 1], [0, 0]]])
    np.testing.assert_array_equal(visualize_attention.mass_masks(a, 0.4), [[[1, 0], [0, 0]]])
