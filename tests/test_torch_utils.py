"""The port's ``utils/pipeline``, ``utils/timing`` and
``ops/faddeeva.voigt_profile`` against the JAX package.

* ``pipelined_batches``: the two cases of ``tests/test_utils.py`` (stream
  order, aux pairing), adapted to the port's unpadded last batch, the bound
  on the batches alive between dispatch and finalize (at most
  ``max_in_flight + 1``), and the readback of tensors in tuples, named
  tuples and lists as numpy arrays;
* ``StageTimer`` as the JAX package's on the same stages; ``block_and_time``
  and ``trace`` on the CPU;
* ``voigt_profile`` in float64 against the JAX one (rtol 1e-12) and
  against ``scipy.special.voigt_profile`` (rtol 1e-10, and 1e-12 of the
  peak absolute where a pure Gaussian's far tail underflows: the same
  formula, the Faddeeva function's ~1e-12 relative accuracy).
"""

import json
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch
from scipy.special import voigt_profile as scipy_voigt_profile

from gpy_dla_detection_tpu.ops.faddeeva import voigt_profile as J_voigt_profile
from gpy_dla_detection_tpu.utils.timing import StageTimer as JStageTimer
from gpy_dla_detection_tpu_torch.ops.faddeeva import voigt_profile
from gpy_dla_detection_tpu_torch.utils.pipeline import pipelined_batches, start_readback
from gpy_dla_detection_tpu_torch.utils.timing import (
    StageTimer,
    block_and_time,
    card_line,
    trace,
)

torch.set_num_threads(2)


def test_pipelined_batches_order_unpadded_and_aux():
    dispatched = []

    def dispatch_fn(chunk, chunk_aux):
        assert chunk_aux is not None and len(chunk_aux) == len(chunk)
        dispatched.append((list(chunk), list(chunk_aux)))
        return np.asarray(chunk) * 10 + np.asarray(chunk_aux)

    def finalize_fn(n, out):
        assert len(out) == n
        for i in range(n):
            yield int(out[i])

    items = list(range(10))
    aux = iter(range(100, 200))  # consumed lazily, one per item
    results = pipelined_batches(
        items, batch_size=4, max_in_flight=1,
        dispatch_fn=dispatch_fn, finalize_fn=finalize_fn, aux=aux,
    )
    # per-item results in stream order
    assert results == [i * 10 + 100 + i for i in range(10)]
    assert len(dispatched) == 3
    # the short final batch arrives at its own size, with its own aux
    assert dispatched[-1][0] == [8, 9]
    assert dispatched[-1][1] == [108, 109]
    # aux was consumed exactly once per item
    assert next(aux) == 110


def test_pipelined_batches_without_aux():
    calls = []

    def dispatch_fn(chunk, chunk_aux):
        assert chunk_aux is None
        calls.append(list(chunk))
        return list(chunk)

    results = pipelined_batches(
        [1, 2, 3], batch_size=2, max_in_flight=8,
        dispatch_fn=dispatch_fn,
        finalize_fn=lambda n, out: out[:n],
    )
    assert results == [1, 2, 3]
    assert calls == [[1, 2], [3]]


@pytest.mark.parametrize("max_in_flight", [0, 1, 3])
def test_pipelined_batches_bounds_the_live_batches(max_in_flight):
    """Counted by ``dispatch_fn`` and ``finalize_fn``: once more than
    ``max_in_flight`` batches are in flight the oldest is drained, so
    ``max_in_flight = 0`` finalizes each batch before the next dispatch;
    the items are pulled as the batches dispatch."""
    live, most, pulled = [0], [0], []

    def items():
        for i in range(11):
            pulled.append(i)
            yield i

    def dispatch_fn(chunk, _):
        live[0] += 1
        most[0] = max(most[0], live[0])
        return torch.tensor(chunk)

    def finalize_fn(n, out):
        live[0] -= 1
        assert isinstance(out, np.ndarray) and out.shape == (n,)
        # no batch beyond the window was pulled before this one drains
        assert len(pulled) <= out[-1] + 1 + 2 * (max_in_flight + 1)
        return out.tolist()

    results = pipelined_batches(items(), 2, max_in_flight, dispatch_fn, finalize_fn)
    assert results == list(range(11))
    assert most[0] == min(max_in_flight + 1, 6) and live[0] == 0


class _Pair(NamedTuple):
    a: torch.Tensor
    b: object


def test_start_readback_maps_every_tensor_to_numpy():
    out = (torch.arange(3.0), _Pair(torch.ones(2, dtype=torch.int64), None),
           [torch.zeros(1, dtype=torch.bool), "keep"])
    pending = start_readback(out)
    assert pending.done is None  # nothing on a CUDA device
    got = pending.result()
    assert isinstance(got, tuple) and isinstance(got[1], _Pair) and isinstance(got[2], list)
    np.testing.assert_array_equal(got[0], [0.0, 1.0, 2.0])
    assert got[1].a.dtype == np.int64 and got[1].b is None
    assert got[2][0].dtype == np.bool_ and got[2][1] == "keep"
    # the host copies are copies
    out[0][0] = 5.0
    assert got[0][0] == 0.0


def test_stage_timer_matches_jax():
    def fill(timer):
        for name, n in (("a", 3), ("b", 1), ("a", 2)):
            for _ in range(n):
                with timer.stage(name):
                    pass
        return timer

    got, want = fill(StageTimer()), fill(JStageTimer())
    assert dict(got.counts) == dict(want.counts) == {"a": 5, "b": 1}
    assert set(got.totals) == set(want.totals)
    assert [line.split()[0] for line in got.report().splitlines()] == sorted(
        got.totals, key=got.totals.get, reverse=True)
    assert all("calls" in line for line in got.report().splitlines())


def test_block_and_time_on_the_cpu():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        time.sleep(0.002)
        return torch.full((2,), x * scale)

    out, best = block_and_time(fn, 3.0, repeats=4, device="cpu", scale=2.0)
    assert torch.equal(out, torch.full((2,), 6.0))
    assert len(calls) == 5 and 0.002 <= best < 1.0
    assert card_line("cpu") == "cpu"


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as path:
        torch.ones(64).cumsum(0)
    events = json.loads(open(path).read())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)


def test_voigt_profile_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    v = np.concatenate([np.linspace(-40.0, 40.0, 401), rng.normal(0.0, 2e3, 200)])
    for sigma, gamma in ((1.0, 0.0), (3.0, 0.5), (0.7, 4.0), (12.0, 1e-3)):
        got = voigt_profile(torch.as_tensor(v, dtype=torch.float64), sigma, gamma).numpy()
        np.testing.assert_allclose(got, np.asarray(J_voigt_profile(v, sigma, gamma)),
                                   rtol=1e-12, atol=0)
        want = scipy_voigt_profile(v, sigma, gamma)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * want.max())
    # broadcasting over per-sample widths
    sig = torch.tensor([[1.0], [2.0]], dtype=torch.float64)
    out = voigt_profile(torch.as_tensor(v[:5]), sig, 0.3)
    assert out.shape == (2, 5)
    np.testing.assert_allclose(out[1].numpy(), scipy_voigt_profile(v[:5], 2.0, 0.3), rtol=1e-10)
