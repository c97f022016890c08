"""The frozen counts against values worked by hand at ViT-L/14 @ 588, and
against the program's own count that they were copied from."""

import pytest

from benchmark.counts import flops

E, N = 1024, 42 * 42          # ViT-L width; 1764 patch tokens at 588 px


def block(n):                  # qkv, proj, fc1, fc2 (4·E hidden) + q·kᵀ and p·v
    return 2 * n * E * E * (3 + 1 + 8) + 4 * n * n * E


def conv(h, k, cin, cout):
    return 2 * h * h * k * k * cin * cout


FROZEN = 24 * (block(1765) + block(1764)) + 2 * (2 * N * 14 * 14 * 3 * E)
ENC = (conv(294, 3, 3, 64) + 2 * conv(294, 3, 64, 64) + conv(73, 3, 64, 128)
       + conv(36, 3, 128, 256) + conv(18, 3, 256, 512) + conv(147, 1, 64, E)
       + conv(73, 1, 128, E) + conv(36, 1, 256, E) + conv(18, 1, 512, E))
DEC = (conv(42, 3, 3 * E, 512) + conv(84, 3, 512, 256) + conv(168, 3, 256, 128)
       + conv(336, 3, 128, 64) + conv(672, 3, 64, 2))
N_CNN = 73 * 73 + 36 * 36 + 18 * 18


def msda(lq, lv, levels):
    return (2 * lv * E * E + 2 * lq * E * E + 2 * lq * E * 8 * levels * 4 * 3
            + 2 * lq * 8 * levels * 4 * 5 * 128)


ADAPT = 4 * (msda(N, N_CNN, 3) + msda(N_CNN, N, 1) + 2 * N_CNN * E * 256 * 2
             + 2 * N_CNN * 9 * 256)


def test_frozen_walks_by_hand():
    assert FROZEN == 2_747_824_373_760
    assert flops.walk_flops(1) + 2 * (2 * N * 14 * 14 * 3 * E) == FROZEN


@pytest.mark.parametrize("batch", [1, 12, 16])
def test_train_step_by_hand(batch):
    assert flops.train_step_flops(batch) == batch * (FROZEN + 3 * (ADAPT + ENC + DEC))
    assert flops.forward_flops(batch) == batch * (FROZEN + ADAPT + ENC + DEC)


def test_train_step_12_value():
    assert flops.train_step_flops(12) == 44_084_120_057_856


def test_walk_bytes_by_hand():
    weights = 3 * E * E + 3 * E + E * E + E + 2 * E * 4096 + 4096 + E + 4 * E + 2 * E
    tokens = 2 * 16 * (1765 + 1764) * E
    assert flops.walk_bytes(16, 2) == 2 * 24 * (tokens + 2 * weights)


@pytest.mark.parametrize("args", [(12, 588), (16, 588), (2, 112), (8, 224)])
def test_copy_matches_the_program_it_was_copied_from(args):
    from adaptersis_tpu_torch.utils import flops as program_flops
    batch, size = args
    assert flops.train_step_flops(batch, size) == program_flops.train_step_flops(batch, size)
