"""The adapter model's MLA and SETR decoders (`AdapterSegmentor`
decoder_type "mla", the four adapter rounds' outputs through DecoderMLA,
and "setr") against the JAX package's at vit_test width on 56 px frames
(`segmentor_parity.run`): fp32 logits, the fp32 train step's loss (DC
after the trainer's softmax) and BatchNorm statistics, and the step's
gradients per flax path in float64. The MLA case runs with
`mla_last_block_bug` (train_mla.py's fault: the last round re-runs block
depth − 2). `parity_frozen_head` is held on both decoders: the decoder's
gradients are those of the step without it, bit for bit, and nothing else
gets one."""

import numpy as np
import pytest
import torch

from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
from adaptersis_tpu_torch.train.convert import seeded_init_
from segmentor_parity import (
    ADAPTER, VIT, batch, check_gradients, check_logits, check_loss_and_stats, run, torch_step)

from torch_parity import single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

CASES = {"mla, last block bug": (("decoder_type", "mla"), ("mla_last_block_bug", True)),
         "setr": (("decoder_type", "setr"),)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match(case):
    check_logits(run("adapter", CASES[case]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_loss_and_batch_stats_match(case):
    check_loss_and_stats(run("adapter", CASES[case]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_gradients_match(case):
    check_gradients(run("adapter", CASES[case]))


def _model(**flags):
    """A seeded model (LayerScale γ ~ N(0, 0.1²): every block moves its tokens)."""
    return seeded_init_(AdapterSegmentor(DinoVisionTransformer(gelu_approx=True, **VIT),
                                         **ADAPTER, **flags), 5)


@pytest.mark.parametrize("decoder", ["mla", "setr"])
def test_frozen_head_trains_the_decoder_alone(decoder):
    x, y = (torch.from_numpy(a) for a in batch())
    free, frozen = (torch_step(_model(decoder_type=decoder, parity_frozen_head=f), x, y.long(),
                               "dc", True)[1] for f in (False, True))
    assert set(free) == set(frozen)
    for k, g in frozen.items():
        if k.startswith("decoder/"):
            np.testing.assert_array_equal(g, free[k], err_msg=k)
        else:
            assert not g.any(), k


def test_last_block_bug_changes_the_walk():
    """The fault re-runs block depth − 2 in the last round: the logits move."""
    x = torch.from_numpy(batch()[0])
    with torch.no_grad():
        a, b = (_model(decoder_type="mla", mla_last_block_bug=bug).eval()(x)
                for bug in (False, True))
    assert (a - b).abs().max() > 1e-3 * a.abs().max()
