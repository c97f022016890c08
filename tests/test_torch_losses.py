"""The port's loss zoo against the JAX package's (`losses/`), fp32 on both
sides: every `--loss` name of the registry and the other public functions
(options the registry does not reach: batch dice, no background, masks,
squares, alphas, reductions, the boundary losses), value and gradient with
respect to the predictions, within 1e-5·max(1, |ref|); and the exact EDT
(`ops/edt.py`) against the JAX package's and against scipy's
distance_transform_edt, bit for bit."""

import importlib

import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt

import jax
import jax.numpy as jnp

import adaptersis_tpu.losses as JL
import adaptersis_tpu_torch.losses as TL

jax_edt = importlib.import_module("adaptersis_tpu.ops.edt")
torch_edt = importlib.import_module("adaptersis_tpu_torch.ops.edt")

from torch_parity import single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

SHAPE = (2, 12, 11)


def _inputs(C: int, seed: int):
    """Logits of scale 2 (softmax away from uniform), labels with every class
    present, a pixel mask and a boundary map."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(SHAPE + (C,))).astype(np.float32)
    y = rng.integers(0, C, SHAPE).astype(np.int32)
    y[:, 0, :C] = np.arange(C)
    mask = (rng.uniform(size=SHAPE) < 0.8).astype(np.float32)
    bound = rng.standard_normal(SHAPE + (C,)).astype(np.float32)
    return x, y, mask, bound


def _check(fn, C: int, seed: int = 0):
    """fn(L, x, y, mask, bound) for the JAX package (L = JL, jnp arrays) and
    the port (L = TL, torch tensors): value and d/dx."""
    x, y, mask, bound = _inputs(C, seed)
    jv, jg = jax.value_and_grad(lambda a: fn(JL, a, jnp.asarray(y), jnp.asarray(mask),
                                             jnp.asarray(bound)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tv = fn(TL, xt, torch.from_numpy(y).long(), torch.from_numpy(mask), torch.from_numpy(bound))
    tv.backward()
    jv, jg, tv = float(jv), np.asarray(jg), tv.item()
    assert np.isfinite(jv) and abs(tv - jv) <= 1e-5 * max(1.0, abs(jv)), (tv, jv)
    g = xt.grad.numpy()
    np.testing.assert_allclose(g, jg, atol=1e-5 * max(1.0, np.abs(jg).max()), rtol=0)
    return jv, jg


@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("name", sorted(JL.LOSSES))
def test_registry_loss_matches_jax(name, C):
    """"masktrans" is a two-class loss (CE with class weights [0.1, 10]):
    with three classes the port raises, as torch's CrossEntropyLoss does in
    the reference, where JAX's gather clamps the class index."""
    assert name in TL.LOSSES
    if name == "masktrans" and C == 3:
        x, y, _, _ = _inputs(C, 0)
        with pytest.raises(ValueError, match="2 class weights for 3 classes"):
            TL.LOSSES[name](torch.from_numpy(x), torch.from_numpy(y))
        return
    _, g = _check(lambda L, x, y, m, b: L.LOSSES[name](x, y), C)
    if name != "hausdorff_er" or C == 2:
        assert np.abs(g).max() > 0, f"{name}: the gradient vanishes on both sides"


def _softmax(L):
    return L.softmax_cl


OPTIONS = {
    "soft_dice batch, no bg, mask, square": lambda L, x, y, m, b: L.soft_dice_loss(
        x, y, apply_nonlin=_softmax(L), batch_dice=True, do_bg=False, square=True, loss_mask=m),
    "iou_nnunet batch": lambda L, x, y, m, b: L.iou_nnunet_loss(
        x, y, apply_nonlin=_softmax(L), batch_dice=True),
    "tversky no bg": lambda L, x, y, m, b: L.tversky_loss(
        x, y, apply_nonlin=_softmax(L), do_bg=False),
    "focal_tversky gamma 1.5": lambda L, x, y, m, b: L.focal_tversky_loss(
        x, y, gamma=1.5, apply_nonlin=_softmax(L)),
    "asym square": lambda L, x, y, m, b: L.asym_loss(
        x, y, apply_nonlin=_softmax(L), square=True),
    "ss": lambda L, x, y, m, b: L.ss_loss(x, y, apply_nonlin=_softmax(L)),
    "ss batch, no bg": lambda L, x, y, m, b: L.ss_loss(
        x, y, apply_nonlin=_softmax(L), batch_dice=True, do_bg=False),
    "gdice_v2": lambda L, x, y, m, b: L.gdice_v2_loss(x, y, apply_nonlin=_softmax(L)),
    "penalty_gdice": lambda L, x, y, m, b: L.penalty_gdice_loss(x, y),
    "dc_and_topk k 25": lambda L, x, y, m, b: L.dc_and_topk_loss(x, y, k=25),
    "explog gamma 0.5": lambda L, x, y, m, b: L.explog_loss(x, y, gamma=0.5),
    "crossentropy_nd weighted": lambda L, x, y, m, b: L.crossentropy_nd(
        x, y, weight=[0.5, 2.0, 1.0][:x.shape[-1]]),
    "weighted_crossentropy": lambda L, x, y, m, b: L.weighted_crossentropy(x, y),
    "dist_penalized_ce": lambda L, x, y, m, b: L.dist_penalized_ce(x, y),
    "dist_penalized_ce_weighted": lambda L, x, y, m, b: L.dist_penalized_ce_weighted(x, y),
    "focal alpha list": lambda L, x, y, m, b: L.focal_loss(
        L.softmax_cl(x), y, alpha=[1.0, 2.0, 3.0][:x.shape[-1]], gamma=1.5),
    "focal alpha float, sum": lambda L, x, y, m, b: L.focal_loss(
        L.softmax_cl(x), y, alpha=0.25, balance_index=1, size_average=False),
    "lovasz sum": lambda L, x, y, m, b: L.lovasz_softmax(L.softmax_cl(x), y, reduction="sum"),
    "lovasz none": lambda L, x, y, m, b: L.lovasz_softmax(
        L.softmax_cl(x), y, reduction="none").sum(),
    "bd": lambda L, x, y, m, b: L.bd_loss(x, b),
    "dc_and_bd": lambda L, x, y, m, b: L.dc_and_bd_loss(x, y, b),
    "hausdorff_dt alpha 1": lambda L, x, y, m, b: L.hausdorff_dt_loss(
        L.softmax_cl(x)[..., 1], y, alpha=1.0),
    "hausdorff_er 3 erosions": lambda L, x, y, m, b: L.hausdorff_er_loss(
        L.softmax_cl(x)[..., 1], y, erosions=3),
    "get_tp_fp_fn mask, square": lambda L, x, y, m, b: sum(
        (t * w).sum() for t, w in zip(L.get_tp_fp_fn(L.softmax_cl(x), y, mask=m, square=True),
                                      (1.0, 2.0, 3.0))),
    "flat_dice_coefficient": lambda L, x, y, m, b: L.flat_dice_coefficient(
        L.softmax_cl(x)[..., 1], y),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_loss_option_matches_jax(name):
    _check(OPTIONS[name], 3, seed=1)


def _masks():
    rng = np.random.default_rng(3)
    m = rng.uniform(size=(4, 37, 23)) > 0.7
    m[2] = False                     # no foreground
    m[3, 5:30, 4:20] = True          # a block with a deep inside
    return m


def test_edt_matches_jax_and_scipy_exactly():
    m = _masks()
    got = torch_edt.edt(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_edt.edt(jnp.asarray(m))))
    want = np.stack([distance_transform_edt(a) for a in m]).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    # a map with no background: the JAX package's capped distances
    full = np.ones((1, 6, 7), bool)
    np.testing.assert_array_equal(torch_edt.edt(torch.from_numpy(full)).numpy(),
                                  np.asarray(jax_edt.edt(jnp.asarray(full))))


@pytest.mark.parametrize("fn", ["edt_signed_pair", "penalized_distance_map"])
def test_distance_maps_match_jax(fn):
    m = _masks()[:2]
    got = getattr(torch_edt, fn)(torch.from_numpy(m)).numpy()
    want = np.asarray(getattr(jax_edt, fn)(jnp.asarray(m)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_edt_blocks_rows_as_one():
    """The min-plus product in blocks of rows gives the same bits as in one."""
    m = torch.from_numpy(_masks())
    whole = torch_edt.edt(m)
    kept = torch_edt._BLOCK_ELEMENTS
    try:
        torch_edt._BLOCK_ELEMENTS = 4 * 37 * 23 * 5       # 5 rows a block
        assert torch.equal(torch_edt.edt(m), whole)
    finally:
        torch_edt._BLOCK_ELEMENTS = kept
