"""The port's float32 rate calibration (utils/fp32_rate.py) against the JAX
package's benchmarks/micro_vpu.py: the quadratic map's plain version
against the Pallas kernel in interpret mode, the interval the map keeps its
values in, the wrapper's CPU route, and ``fp32_rate``'s refusal to measure
anything but a card. The kernel itself (csrc/quad_map.cu) runs on the card
only: chip_smoke.py holds it against the plain version there."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu_torch.utils import fp32_rate as FR

ROOT = Path(__file__).resolve().parent.parent
ULP_1 = 2.0 ** -23                     # float32 spacing in [1, 2)


def _micro_vpu():
    """benchmarks/micro_vpu.py, loaded by path (the folder is no package)."""
    spec = importlib.util.spec_from_file_location(
        "micro_vpu", ROOT / "benchmarks" / "micro_vpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _block(seed=0):
    """A (512, 1024) block uniform in [-1, 1.6], inside [a - a^2, a]."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.6, size=FR.SHAPE).astype(np.float32)


def _tolerance(iters):
    """How far two roundings of the map may drift apart in ``iters`` steps.

    XLA:CPU contracts a - x*x into an FMA and the plain version rounds the
    product and the difference apart: one step's results then differ by at
    most eps = 4 ulp of [1, 2) (two roundings, a's own rounding, one
    spare), and a difference d grows to at most |2x| d <= 2a d in the next
    step (|x| <= a on the invariant interval), so after L steps it is at
    most eps (g^L - 1) / (g - 1), g = 2a.
    """
    eps, g = 4 * ULP_1, 2 * 1.62
    return eps * (g ** iters - 1) / (g - 1)


@pytest.mark.parametrize("iters", [1, 2, 4, 8])
def test_plain_matches_the_jax_kernel_in_interpret_mode(iters):
    """quad_map_plain against micro_vpu.make_kernel(L, interpret=True) on a
    seeded (512, 1024) block, within the drift bound of _tolerance (the map
    is chaotic at a = 1.62, so the comparison stays at small L)."""
    x = _block()
    want = np.asarray(_micro_vpu().make_kernel(iters, interpret=True)(jnp.asarray(x)))
    got = FR.quad_map_plain(torch.from_numpy(x), iters).numpy()
    assert got.dtype == np.float32 and got.shape == FR.SHAPE
    err = np.abs(got.astype(np.float64) - want)
    assert err.max() <= _tolerance(iters), (iters, err.max())


def test_plain_rounds_every_operation_as_numpy_does():
    """The plain version is the uncontracted map: each multiply, add and
    subtract rounded to float32, as numpy computes it op by op, bit for bit
    at L = 64 (the card's uncontracted kernel is held to the same bits)."""
    x = _block(1)
    a = x * np.float32(1e-7) + np.float32(1.62)
    want = x.copy()
    for _ in range(64):
        want = a - want * want
    got = FR.quad_map_plain(torch.from_numpy(x), 64).numpy()
    assert np.array_equal(got, want)


def test_values_stay_in_the_invariant_interval():
    """From inside [a - a^2, a] the map stays there: x <= a because x^2 >=
    0, and x >= a - a^2 because |x| <= a. At L = 64, where the values are
    long decorrelated from the input, every element lies in it within 4
    ulps of [1, 2) (the roundings of x^2 and of the difference)."""
    x = _block(2)
    a = (x * np.float32(1e-7) + np.float32(1.62)).astype(np.float64)
    got = FR.quad_map_plain(torch.from_numpy(x), 64).numpy().astype(np.float64)
    slack = 4 * ULP_1
    assert (got <= a + slack).all() and (got >= a - a * a - slack).all()
    assert got.min() < 0.0 < got.max()


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    x = torch.from_numpy(_block(3))
    assert torch.equal(FR.quad_map(x, 5), FR.quad_map_plain(x, 5))
    assert torch.equal(FR.quad_map(x, 0), x)


@pytest.mark.parametrize("case", ["contracted", "negative", "too_many", "float64"])
def test_wrapper_raises_on_what_it_does_not_take(case):
    """The contracted instance has no plain version (it runs on the card
    only); iters outside [0, 2^30] and other dtypes are refused."""
    x = torch.from_numpy(_block(4)[:4, :8])
    args = dict(contracted=(x, 1, True), negative=(x, -1, False),
                too_many=(x, FR.MAX_ITERS + 1, False),
                float64=(x.double(), 1, False))[case]
    with pytest.raises(ValueError):
        FR.quad_map(*args)


def test_fp32_rate_refuses_to_run_without_a_card(monkeypatch):
    """No CPU fallback: a rate measured anywhere else is not the card's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        FR.fp32_rate()
