"""`adaptersis_tpu_torch.quality_parity` against the JAX package's
`tools/quality_parity.py`: on the same fabricated `log.txt` and reference
JSON (training replaced by nothing on both sides) the same final metrics,
printed table, verdicts, `parity.json`, `parity.md` and exit code, over the
tolerance's edge, a better value outside it, `loss` lower-is-better, a
metric missing from the reference and the multi-class keys; then a tiny
synthetic dry run on the CPU that passes one reference and fails
another."""

import json
import os
import sys

import pytest

from adaptersis_tpu_torch import quality_parity, train_seg

from torch_parity import single_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("single_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import quality_parity as tool
    return tool


# (the log's last test_* row, an earlier one, the reference, the tolerance);
# dyadic values, so that "exactly at the tolerance" is exact in binary
CASES = {
    "at the tolerance": ({"test_dice": 0.75, "test_acc1": 0.875, "test_loss": 0.5},
                         {"dice": 0.8125, "acc1": 0.8125, "loss": 0.4375}, 0.0625),
    "just past the tolerance": ({"test_dice": 0.75, "test_acc1": 0.875, "test_loss": 0.5},
                                {"dice": 0.8125, "acc1": 0.875, "loss": 0.5}, 0.0546875),
    "better outside it": ({"test_dice": 0.9375, "test_acc1": 0.96875, "test_loss": 0.25},
                          {"dice": 0.5, "acc1": 0.5, "loss": 1.0}, 0.003),
    "loss lower is better": ({"test_dice": 0.5, "test_acc1": 0.5, "test_loss": 0.75},
                             {"dice": 0.5, "acc1": 0.5, "loss": 0.5}, 0.003),
    "missing from the reference": ({"test_dice": 0.5, "test_acc1": 0.25, "test_loss": 0.5},
                                   {"dice": 0.5}, 0.003),
    "multi-class keys": ({"test_dice": 0.5, "test_acc1": 0.75, "test_loss": 1.5,
                          "test_ch_iou": 0.375, "test_isi_iou": 0.3125},
                         {"dice": 0.5, "ch_iou": 0.5, "isi_iou": 0.3125}, 0.003),
    "no reference": ({"test_dice": 0.5, "test_acc1": 0.75, "test_loss": 1.5}, None, 0.003),
}


def _write_run(d, last, reference):
    d.mkdir()
    rows = [{"train_loss": 1.0, "epoch": 0},
            {"train_loss": 0.9, "epoch": 1, **{k: v / 2 for k, v in last.items()}},
            {"train_loss": 0.8, "epoch": 2, "device": "cpu", **last}]
    (d / "log.txt").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    argv = ["--output_dir", str(d)]
    if reference is not None:
        (d / "ref.json").write_text(json.dumps(reference))
        argv += ["--reference_json", str(d / "ref.json")]
    return argv


def _exit_code(main):
    try:
        main()
    except SystemExit as e:
        return e.code
    return 0


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_the_jax_tool(case, jax_tool, tmp_path, monkeypatch, capsys):
    last, reference, tol = CASES[case]
    jax_argv = _write_run(tmp_path / "jax", last, reference) + ["--tolerance", str(tol)]
    port_argv = _write_run(tmp_path / "port", last, reference) + ["--tolerance", str(tol)]
    monkeypatch.setattr(jax_tool.train_mod, "train_seg", lambda args: None)
    monkeypatch.setattr(train_seg, "run", lambda args: (None, []))

    assert (quality_parity.final_metrics(str(tmp_path / "port"))
            == jax_tool.final_metrics(str(tmp_path / "jax")))
    monkeypatch.setattr(sys, "argv", ["quality_parity.py"] + jax_argv)
    jax_code = _exit_code(jax_tool.main)
    jax_out = capsys.readouterr().out
    port_code = _exit_code(lambda: quality_parity.main(port_argv))
    port_out = capsys.readouterr().out
    assert port_out == jax_out and port_code == jax_code
    for name in ("parity.json", "parity.md"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    got = json.loads((tmp_path / "port" / "parity.json").read_text())
    assert set(got) == {"metrics", "reference", "tolerance", "parity_ok"}
    # the verdicts this case is about
    verdicts = dict(line.strip("| ").split(" | ")[::4] for line in port_out.splitlines()[2:])
    want = {"at the tolerance": {"dice": "PASS", "acc1": "PASS", "loss": "PASS"},
            "just past the tolerance": {"dice": "FAIL", "acc1": "PASS", "loss": "PASS"},
            "better outside it": {"dice": "PASS", "acc1": "PASS", "loss": "PASS"},
            "loss lower is better": {"dice": "PASS", "acc1": "PASS", "loss": "FAIL"},
            "missing from the reference": {"dice": "PASS", "acc1": "—", "loss": "—"},
            "multi-class keys": {"dice": "PASS", "acc1": "—", "ch_iou": "FAIL",
                                 "isi_iou": "PASS", "loss": "—"},
            "no reference": {"dice": "—", "acc1": "—", "loss": "—"}}[case]
    assert verdicts == want
    assert port_code == (1 if "FAIL" in want.values() else 0) == (0 if got["parity_ok"] else 1)


def test_dry_run_on_cpu(tmp_path):
    """A tiny synthetic run at vit_test width on the CPU, compared with a
    reference it passes (exit 0), then with its dice + 0.05 (exit 1; the
    finished run trains nothing more)."""
    out = tmp_path / "run"
    argv = ["--device", "cpu", "--synthetic", "--epochs", "1", "--arch", "vit_test",
            "--patch_size", "14", "--imsize", "56", "--batch_size_per_gpu", "2",
            "--num_workers", "2", "--output_dir", str(out)]
    (tmp_path / "pass.json").write_text(json.dumps({"dice": 0.0, "acc1": 0.0, "loss": 1e9}))
    res = quality_parity.main(argv + ["--reference_json", str(tmp_path / "pass.json")])
    rows = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert res["metrics"] == {k[5:]: v for k, v in rows[-1].items() if k.startswith("test_")}
    assert set(res["metrics"]) == {"dice", "acc1", "loss"} and res["parity_ok"]
    assert json.loads((out / "parity.json").read_text()) == res
    worse = {"dice": res["metrics"]["dice"] + 0.05}
    (tmp_path / "fail.json").write_text(json.dumps(worse))
    with pytest.raises(SystemExit) as e:
        quality_parity.main(argv + ["--reference_json", str(tmp_path / "fail.json")])
    assert e.value.code == 1
    got = json.loads((out / "parity.json").read_text())
    assert set(got) == {"metrics", "reference", "tolerance", "parity_ok"}
    assert got["reference"] == worse and not got["parity_ok"] and got["tolerance"] == 0.003
    assert "| dice |" in (out / "parity.md").read_text()
    assert len((out / "log.txt").read_text().splitlines()) == 1


def test_defaults_to_the_card(monkeypatch):
    assert quality_parity.get_args_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        quality_parity.main(["--arch", "vit_test", "--patch_size", "14", "--imsize", "56",
                             "--synthetic"])
