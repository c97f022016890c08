"""The launch helpers every kernel wrapper shares (adaptersis_tpu_torch/
ops/_build.py), on CPU tensors: which parameters the kernels read in place,
which are cast, and what the argument checks refuse. The checks come before
the device check, so a CPU tensor reaches each refusal."""

import pytest
import torch

from adaptersis_tpu_torch.ops import _build


def _x(C=128, dtype=torch.bfloat16):
    return torch.zeros(2, 37, C, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_params_are_read_in_place(dtype):
    """Parameters already in one kernel dtype, contiguous and aligned come
    back as the same tensors: no copy, no cast."""
    w, b, g = (torch.randn(n).to(dtype) for n in (128, 384, 128))
    ts, pbf = _build.params("f", _x(), ("w", w, 128), ("b", b, 384), ("g", g, 128))
    assert pbf == int(dtype == torch.bfloat16)
    assert all(t is s for t, s in zip(ts, (w, b, g)))
    assert [t.data_ptr() for t in ts] == [w.data_ptr(), b.data_ptr(), g.data_ptr()]


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32),
                                    (torch.float16, torch.float16),
                                    (torch.float32, torch.float16)])
def test_params_cast_mixed_or_other_dtypes_to_fp32(dtypes):
    w, b = torch.randn(128).to(dtypes[0]), torch.randn(128).to(dtypes[1])
    (wd, bd), pbf = _build.params("f", _x(), ("w", w, 128), ("b", b, 128))
    assert pbf == 0 and wd.dtype == bd.dtype == torch.float32
    torch.testing.assert_close(wd, w.float(), rtol=0, atol=0)
    torch.testing.assert_close(bd, b.float(), rtol=0, atol=0)


def test_params_copy_a_strided_vector():
    w = torch.randn(256).to(torch.bfloat16)[::2]
    (wd,), pbf = _build.params("f", _x(), ("w", w, 128))
    assert pbf == 1 and wd.is_contiguous() and wd.data_ptr() != w.data_ptr()
    torch.testing.assert_close(wd, w, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["shape", "device", "misaligned"])
def test_params_refuse(case):
    w = torch.randn(128).to(torch.bfloat16)
    x = _x()
    if case == "shape":
        w, match = torch.randn(64).to(torch.bfloat16), "f w: expected shape"
    elif case == "device":
        x, match = torch.empty(2, 37, 128, dtype=torch.bfloat16, device="meta"), "f w: expected"
    else:
        w, match = torch.randn(129).to(torch.bfloat16)[1:], "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        _build.params("f", x, ("w", w, 128))


def test_mat_reads_in_place_or_casts_to_x_dtype():
    w = torch.randn(384, 128).to(torch.bfloat16)
    assert _build.mat(w, (384, 128), "m", _x()) is w
    got = _build.mat(w, (384, 128), "m", _x(dtype=torch.float32))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, w.float(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="m: expected shape"):
        _build.mat(w, (128, 384), "m", _x())
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.mat(torch.randn(384 * 128 + 1).to(torch.bfloat16)[1:].view(384, 128),
                   (384, 128), "m", _x())


@pytest.mark.parametrize("case,match", [
    ("float16", "dtype must be bf16 or fp32"),
    ("width 96", "multiple of 64"),
    ("bf16 width 4160", "at most 4096"),
    ("fp32 width 2112", "at most 4096 \\(bf16\\) or 2048 \\(fp32\\)"),
    ("strided", "contiguous and 16-byte aligned"),
    ("misaligned", "contiguous and 16-byte aligned"),
    ("cpu", "unsupported device"),
    ("meta", "unsupported device"),
])
def test_check_rows_refuses(case, match):
    x = {"float16": lambda: _x(dtype=torch.float16),
         "width 96": lambda: _x(C=96),
         "bf16 width 4160": lambda: _x(C=4160),
         "fp32 width 2112": lambda: _x(C=2112, dtype=torch.float32),
         "strided": lambda: _x(C=256)[..., ::2],
         "misaligned": lambda: torch.zeros(2 * 37 * 128 + 1, dtype=torch.bfloat16)[1:]
         .view(2, 37, 128),
         "cpu": _x,
         "meta": lambda: torch.empty(2, 37, 128, dtype=torch.bfloat16, device="meta")}[case]()
    with pytest.raises(ValueError, match=match):
        _build.check_rows("rows", x)


@pytest.mark.parametrize("C,dtype", [(4096, torch.bfloat16), (2048, torch.float32),
                                     (64, torch.float32)])
def test_check_rows_reaches_the_device_check_at_the_widest_rows(C, dtype):
    """The widest rows the statistics pass holds pass every check but the
    device's."""
    with pytest.raises(ValueError, match="unsupported device"):
        _build.check_rows("rows", _x(C=C, dtype=dtype))
