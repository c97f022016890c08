"""The port's utilities (`utils/misc.py`, `utils/colormaps.py`,
`utils/setup_logging.py`, `utils/logging.py:profile_trace`) against the JAX
package's: LARS (a torch optimizer) against the JAX optax transformation
over 3 steps on 1-D and 2-D parameters with weight decay; clip_gradients
over 3 clipped gradient steps; MultiCropWrapper's grouping; PCA and the
revisited Oxford/Paris mAP on seeded data; the colormaps; the glog
formatter and the rank-0 print; and a torch.profiler trace written on the
CPU as Chrome-trace JSON."""

import builtins
import json
import logging

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.utils import colormaps as jcm
from adaptersis_tpu.utils import misc as jmisc
from adaptersis_tpu.utils import setup_logging as jsl
from adaptersis_tpu_torch.utils import colormaps as tcm
from adaptersis_tpu_torch.utils import misc as tmisc
from adaptersis_tpu_torch.utils import setup_logging as tsl
from adaptersis_tpu_torch.utils.logging import profile_trace
from torch_parity import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "zero": np.zeros((3, 3), np.float32)}       # ‖p‖ = 0: no trust scaling


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {"w": rng.standard_normal((5, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "zero": rng.standard_normal((3, 3)).astype(np.float32)}


def test_lars_three_steps():
    start = _params(0)
    tx = jmisc.lars(0.1, momentum=0.9, weight_decay=1e-2, eta=0.01)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    opt = tmisc.LARS(list(tp.values()), lr=0.1, momentum=0.9, weight_decay=1e-2, eta=0.01)
    for step in range(3):
        g = _grads(step)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in start:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {step}")
    # the bias took plain momentum SGD: no decay, no trust ratio
    g = [_grads(i)["b"] for i in range(3)]
    np.testing.assert_allclose(tp["b"].detach().numpy(), start["b"] - 0.1 * (
        2.71 * g[0] + 1.9 * g[1] + g[2]), rtol=1e-5, atol=1e-6)


def test_clip_gradients_three_steps():
    for step, clip in enumerate((0.5, 3.0, 100.0)):
        g = _grads(step)
        want = jmisc.clip_gradients({k: jnp.asarray(v) for k, v in g.items()}, clip)
        params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in g.values()]
        for p, v in zip(params, g.values()):
            p.grad = torch.from_numpy(v.copy())
        norms = tmisc.clip_gradients(params, clip)
        np.testing.assert_allclose(norms, [np.linalg.norm(v) for v in g.values()], rtol=1e-6)
        for p, k in zip(params, g):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
            assert np.linalg.norm(p.grad.numpy()) <= clip * (1 + 1e-5)
    m = torch.nn.Linear(3, 2)
    m.weight.grad = torch.full((2, 3), 10.0)
    assert len(tmisc.clip_gradients(m, 1.0)) == 1          # a module; bias without grad
    assert torch.linalg.norm(m.weight.grad) <= 1.0 + 1e-5


def test_multicrop_wrapper():
    rng = np.random.default_rng(0)
    crops = [rng.standard_normal(s).astype(np.float32)
             for s in ((2, 8, 8, 3), (2, 8, 8, 3), (2, 4, 4, 3), (2, 4, 4, 3), (2, 8, 8, 3))]
    calls = []

    def backbone(x):
        calls.append(tuple(x.shape))
        return x.mean(axis=(1, 2)) if isinstance(x, jax.Array) else x.mean(dim=(1, 2))

    want = jmisc.MultiCropWrapper(backbone, lambda z: z * 2)([jnp.asarray(c) for c in crops])
    jax_calls, calls[:] = list(calls), []
    got = tmisc.MultiCropWrapper(backbone, lambda z: z * 2)([torch.from_numpy(c) for c in crops])
    assert calls == jax_calls == [(4, 8, 8, 3), (4, 4, 4, 3), (2, 8, 8, 3)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    one = tmisc.MultiCropWrapper(backbone, lambda z: z)(torch.from_numpy(crops[0]))
    assert one.shape == (2, 3)


def test_pca(capsys):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 12)) @ rng.standard_normal((12, 12))
    cov = np.cov(x.T)
    cov_low = cov.copy()
    cov_low[:, -1] = cov_low[-1, :] = 0.0                  # an eigenvalue floored
    for c in (cov, cov_low):
        a, b = jmisc.PCA(dim=6), tmisc.PCA(dim=6)
        a.train_pca(c.copy())
        b.train_pca(c.copy())
        a.mean = b.mean = x.mean(0)
        np.testing.assert_allclose(np.abs(b.apply(x)), np.abs(a.apply(x)), rtol=1e-10)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0] == out[1] and out[2] == out[3]


def _ranks_and_gnd(seed):
    rng = np.random.default_rng(seed)
    n_db, nq = 30, 5
    ranks = np.stack([rng.permutation(n_db) for _ in range(nq)], axis=1)
    gnd = []
    for q in range(nq):
        pick = rng.permutation(n_db)
        ok, junk = pick[:4 + q], pick[10:13]
        gnd.append({"ok": ok.tolist(), "junk": junk.tolist()} if q % 2 else
                   {"ok": ok.tolist()})
    gnd.append({"ok": [], "junk": [1]})                     # no positives: left out
    ranks = np.concatenate([ranks, rng.permutation(n_db)[:, None]], axis=1)
    return ranks, gnd


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_map(seed):
    ranks, gnd = _ranks_and_gnd(seed)
    want = jmisc.compute_map(ranks, gnd, kappas=(1, 5, 10))
    got = tmisc.compute_map(ranks, gnd, kappas=(1, 5, 10))
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=1e-12, equal_nan=True)
    assert tmisc.compute_ap(np.array([0, 2, 5]), 4) == jmisc.compute_ap(np.array([0, 2, 5]), 4)


def test_colormaps():
    assert tcm.ADE20K_COLORMAP == jcm.ADE20K_COLORMAP and len(tcm.ADE20K_COLORMAP) == 151
    assert tcm.VOC2012_COLORMAP == jcm.VOC2012_COLORMAP
    for name, n in (("ade20k", 150), ("ade20k", 20), ("ade20k", 160), ("voc", 21),
                    ("pascal_voc", 300)):
        np.testing.assert_array_equal(tcm.get_palette(name, n), jcm.get_palette(name, n))
    mask = np.random.default_rng(0).integers(0, 12, (5, 7))
    for name in ("ade20k", "voc"):
        np.testing.assert_array_equal(tcm.colorize(mask, name), jcm.colorize(mask, name))


def test_setup_logging(tmp_path, capsys):
    ours = tsl.setup_logging(str(tmp_path), name="asis_torch_test")
    ours.info("hello %d", 3)
    theirs = jsl.setup_logging(None, name="asis_jax_test")
    theirs.info("hello %d", 3)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    strip = [ln.split("] ", 1) for ln in lines]
    assert strip[0][1] == strip[1][1] == "hello 3"
    assert strip[0][0].startswith("I") and strip[0][0].endswith("test_torch_misc.py:" +
                                                                 strip[0][0].rsplit(":", 1)[1])
    assert (tmp_path / "log.txt").read_text().splitlines()[0].endswith("] hello 3")
    fmt = tsl._GlogFormatter()
    rec = logging.LogRecord("n", logging.WARNING, "f.py", 7, "m", None, None)
    assert fmt.format(rec).startswith("W") and fmt.format(rec).endswith(" n f.py:7] m")
    for h in ours.handlers:
        h.close()


def test_patch_print_rank0(monkeypatch, capsys):
    saved = builtins.print
    try:
        tsl.patch_print_rank0()
        print("on rank 0")
        monkeypatch.setattr(tsl, "get_rank", lambda: 1)
        print("hidden")
        print("forced", force=True)
    finally:
        builtins.print = saved
    assert capsys.readouterr().out.splitlines() == ["on rank 0", "forced"]


def test_profile_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
