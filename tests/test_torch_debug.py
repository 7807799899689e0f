"""The port's debugging and profiling utilities (`kgtpu_torch/utils/debug.py`,
`utils/profiling.py`) against kgtpu's (`kgtpu/utils/debug.py`,
`profiling.py`): the counterparts of `tests/test_utils.py`'s cost, trace and
checkify cases, and both packages stopping on the same planted NaNs.

kgtpu's `jax_debug_nans` and the port's NaN mode are switched off after
every test that turns them on; kgtpu's results are awaited before torch
computes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgtpu.utils import enable_nan_debugging as jenable_nans
from kgtpu_torch.config import GroupConfig
from kgtpu_torch.ops.decode import Peaks, decode_peaks
from kgtpu_torch.ops.group import group_keypoints
from kgtpu_torch.ops.roi import paste_masks
from kgtpu_torch.utils.debug import checked, disable_nan_debugging, enable_nan_debugging
from kgtpu_torch.utils.profiling import cost_analysis, summarize_cost, trace


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def nans_on():
    """Both packages' NaN checks on for one test, off after it."""
    jenable_nans()
    enable_nan_debugging()
    yield
    jax.config.update("jax_debug_nans", False)
    disable_nan_debugging()


def test_cost_analysis_reports_flops():
    a = torch.zeros(256, 256)
    ca = cost_analysis(lambda p, q: p @ q, a, a)
    assert ca["flops"] == 2 * 256 ** 3
    # an unfused count: both operands read and the product written
    assert ca["bytes accessed"] == 3 * 256 * 256 * 4
    assert "GFLOP" in summarize_cost(lambda p, q: p @ q, a, a, name="matmul")


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        torch.ones(128, 128).sum()
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert files, "no trace files written"


def test_checked_decode_has_no_oob_or_nan():
    rng = np.random.default_rng(0)
    hm = torch.from_numpy(rng.normal(size=(1, 16, 16, 5)).astype(np.float32))
    reg = torch.from_numpy(rng.normal(size=(1, 16, 16, 2)).astype(np.float32))
    err, out = checked(lambda a, b: decode_peaks(a, b, 8))(hm, reg)
    err.throw()
    assert tuple(out.scores.shape) == (1, 5, 8)


def test_checked_group_and_paste_clean():
    """tests/test_utils.py:42's adversarial peaks and degenerate boxes: no
    out-of-range index and no NaN in the grouper or the paste."""
    rng = np.random.default_rng(1)
    k = 16
    peaks = Peaks(torch.from_numpy(rng.uniform(0, 1, (1, 5, k)).astype(np.float32)),
                  torch.from_numpy(rng.uniform(-2, 34, (1, 5, k, 2)).astype(np.float32)),
                  torch.zeros((1, 5, k), dtype=torch.long))
    cfg = GroupConfig(max_peaks_per_class=k, max_detections=8)
    err, _ = checked(lambda p: group_keypoints(p, cfg))(peaks)
    err.throw()
    masks = torch.from_numpy(rng.uniform(0, 1, (8, 8, 8)).astype(np.float32))
    boxes = torch.from_numpy(np.concatenate([rng.uniform(-4, 30, (7, 4)),
                                             [[5.0, 5.0, 5.0, 5.0]]]).astype(np.float32))
    err2, _ = checked(lambda m, b: paste_masks(m, b, torch.ones(8), torch.ones(8, dtype=torch.bool),
                                               32, 32))(masks, boxes)
    err2.throw()


def test_checked_reports_what_checkify_reports():
    """A planted out-of-range gather and a planted NaN: kgtpu's checkify and
    the port's `checked` both return an error that raises, and clean calls
    return none."""
    from kgtpu.utils import checked as jchecked

    idx = np.array([1, 5])
    jerr, _ = jax.jit(jchecked(lambda a, i: a[i]))(jnp.arange(4.0), jnp.asarray(idx))
    with pytest.raises(Exception, match="out-of-bounds"):
        jerr.throw()
    err, out = checked(lambda a, i: a[i])(torch.arange(4.0), torch.from_numpy(idx))
    with pytest.raises(IndexError, match="out-of-bounds"):
        err.throw()
    assert out.tolist() == [1.0, 3.0]                   # clamped, as XLA clamps
    x = np.array([1.0, -1.0], np.float32)
    jerr, _ = jax.jit(jchecked(jnp.log))(jnp.asarray(x))
    with pytest.raises(Exception, match="nan"):
        jerr.throw()
    err, _ = checked(torch.log)(torch.from_numpy(x))
    with pytest.raises(FloatingPointError, match="nan"):
        err.throw()
    err, _ = checked(torch.log)(torch.ones(2))
    assert err.get() is None
    err.throw()


def _planted_forward(np_, x):
    return np_.log(x) * 2.0


@pytest.mark.parametrize("where", ["forward", "backward"])
def test_both_packages_stop_on_the_same_planted_nan(where, nans_on):
    """log of a negative value (forward) and sqrt's gradient at 0 times 0
    (backward): both packages raise FloatingPointError; the port names the
    aten op that produced the NaN."""
    x = np.array([1.0, -1.0], np.float32) if where == "forward" else np.array([1.0, 0.0],
                                                                               np.float32)
    if where == "forward":
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jax.jit(lambda a: _planted_forward(jnp, a))(jnp.asarray(x)))
        with pytest.raises(FloatingPointError, match="aten.log"):
            _planted_forward(torch, torch.from_numpy(x))
    else:
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jax.grad(lambda a: (jnp.sqrt(a) * 0.0).sum())(jnp.asarray(x)))
        t = torch.from_numpy(x).requires_grad_(True)
        with pytest.raises(FloatingPointError, match="nan"):
            (torch.sqrt(t) * 0.0).sum().backward()


def test_nan_debugging_passes_clean_work_and_switches_off(nans_on):
    """Clean ops pass under the checks (allocations whose bytes read as NaN
    included); after `disable_nan_debugging` a NaN passes silently."""
    y = torch.empty(64).fill_(1.0) + torch.log(torch.ones(64))
    assert torch.equal(y, torch.ones(64))
    disable_nan_debugging()
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
