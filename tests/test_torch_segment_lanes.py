"""``segment_lanes`` (the element path's reduction) in its plain version,
with the aggregate's lift and finalize around it
(``ops.evicting_window.reduce_windows`` on the CPU), against the JAX
package's ``_element_window_fn`` run window by window on the same
seeded elements.

Windows of 1 to 5,000 elements; lanes with planted NaN (one per column
and window, of either sign and with a payload), signed zeros and
infinities; ``count()`` (no lanes at all), ``sum_of``, ``max_of``,
``min_of``, ``avg_of``, ``multi`` and a ``lower_aggregate``.

Rules, written before the first run: the same fields in the same order,
the same dtypes; counts, integers, max and min exactly, bit for bit (a
NaN with its sign and payload, -0 apart from +0); a sum of n terms
within (2 * n + 4) * 2^-24 * sum(|terms|) of the reference (the error of
adding the same terms in two orders: XLA's reduction associates its
own way, the port adds in element order), an average within that
bound over n plus 2^-23 * |ref| (one rounding of the division each);
a non-finite sum or average exactly. A lowered aggregate's leaves come
out of its own ``add`` (torch in the port, jnp in the reference), and the
two frameworks give a NaN from ``maximum`` different bits, so a NaN leaf
there is compared as a NaN. Besides, the plain version must
equal a float32 loop over each window in element order, bit for bit:
the arithmetic the CUDA kernel repeats."""
import os
import re

import numpy as np
import pytest
import torch

from flink_tpu.api.datastream import _element_window_fn as jax_element_fn
from flink_tpu.ops import aggregates as ja
from flink_tpu_torch.api.functions import AggregateFunction
from flink_tpu_torch.kernels import element_kernels as ek
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops import aggregates as ta
from flink_tpu_torch.ops.evicting_window import reduce_windows
from test_torch_threads import capped_torch_threads  # noqa: F401

U = 2.0 ** -24
CPU = torch.device("cpu")
# few distinct lengths: the reference compiles its reductions per shape
LENGTHS = [1, 3, 3, 1, 17, 17, 5000, 1, 3, 17, 3, 17]


def nan_bits(sign, payload):
    return np.array([(0xFFC00000 if sign else 0x7FC00000) | payload],
                    np.uint32).view(np.float32)[0]


@pytest.fixture(scope="module")
def windows():
    """(offsets, columns): positive ``p``; ``q`` with specials planted,
    one NaN per window where any; int64 ``n``."""
    rng = np.random.default_rng(20261017)
    offsets = np.concatenate([[0], np.cumsum(LENGTHS)]).astype(np.int64)
    e = int(offsets[-1])
    p = (rng.random(e) * 900 + 50).astype(np.float32)
    q = (rng.normal(0, 100, e)).astype(np.float32)
    n = rng.integers(-1000, 1000, e).astype(np.int64)

    def seg(w):
        return slice(offsets[w], offsets[w + 1])

    q[seg(1)] = [nan_bits(0, 5), 3.0, 4.0]     # +NaN first
    q[seg(2)] = [1.0, nan_bits(1, 77), -2.0]    # -NaN with a payload
    q[seg(4)] = 0.0
    q[offsets[4] + np.arange(0, 17, 3)] = -0.0  # +0 and -0 mixed
    q[seg(7)] = -0.0                            # one -0
    q[seg(8)][[0, 2]] = [np.inf, -np.inf]       # both infinities
    q[offsets[9] + 4] = np.inf
    q[seg(10)] = [-0.0, -0.0, -0.0]
    big = q[seg(6)]
    big[1234] = nan_bits(0, 99)                 # one NaN in 5,000
    big[4000] = np.inf
    return offsets, {"p": p, "q": q, "n": n}


class SumPeakLow:
    """One AggregateFunction body for both packages (``xp`` is jnp or
    torch): a sum, a max and a min leaf of ``q``."""

    def __init__(self, xp):
        self.xp = xp

    def create_accumulator(self):
        xp = self.xp
        return (xp.asarray(0.0, dtype=xp.float32),
                xp.asarray(-np.inf, dtype=xp.float32),
                xp.asarray(np.inf, dtype=xp.float32))

    def add(self, value, acc):
        xp = self.xp
        x = value["q"].astype(xp.float32) if hasattr(value["q"], "astype") \
            else value["q"].to(xp.float32)
        return (acc[0] + x, xp.maximum(acc[1], x), xp.minimum(acc[2], x))

    def merge(self, a, b):
        xp = self.xp
        return (a[0] + b[0], xp.maximum(a[1], b[1]), xp.minimum(a[2], b[2]))

    def get_result(self, acc):
        return {"total": acc[0], "peak": acc[1], "low": acc[2]}


class TorchSumPeakLow(SumPeakLow, AggregateFunction):
    def __init__(self):
        super().__init__(torch)


def aggregates():
    import jax.numpy as jnp

    def both(f):
        return f(ja), f(ta)

    return {
        "count": both(lambda m: m.count()),
        "sum": both(lambda m: m.sum_of("q")),
        "max": both(lambda m: m.max_of("q")),
        "min": both(lambda m: m.min_of("q")),
        "avg": both(lambda m: m.avg_of("n")),
        "multi": both(lambda m: m.multi(m.count("c"), m.avg_of("p"),
                                        m.max_of("q"), m.min_of("q"),
                                        m.sum_of("n"), m.max_of("n"))),
        "lowered": (ja.lower_aggregate(SumPeakLow(jnp), {"q": np.float32}),
                    ta.lower_aggregate(TorchSumPeakLow(), {"q": np.float32})),
    }


AGGS = aggregates()


def term_sums(offsets, col):
    """Per window: sum of |terms| of an f32 lane of ``col``."""
    x = np.abs(col.astype(np.float32).astype(np.float64))
    return np.add.reduceat(x, offsets[:-1])


@pytest.mark.parametrize("name", sorted(AGGS))
def test_plain_reduction_matches_the_reference_window_by_window(name, windows):
    offsets, cols = windows
    jagg, tagg = AGGS[name]
    fields = tagg.fields
    got = reduce_windows(tagg, offsets, {f: cols[f] for f in fields}, CPU)
    fn = jax_element_fn(jagg)
    lens = np.diff(offsets)
    for w in range(len(lens)):
        sl = slice(offsets[w], offsets[w + 1])
        ref = fn({**{f: cols[f][sl] for f in cols},
                  "__ts__": np.arange(lens[w], dtype=np.int64)})
        assert list(got) == list(ref)
        for f, r in ref.items():
            g = got[f][w]
            r = np.asarray(r)
            assert g.dtype == r.dtype, (f, g.dtype, r.dtype)
            src = {"sum_p": "p", "avg_p": "p", "sum_q": "q", "sum_n": "n",
                   "avg_n": "n", "total": "q"}.get(f)
            if name == "lowered" and np.isnan(r):
                assert np.isnan(g), (f, w, g)
                continue
            if src is None or not np.isfinite(r):
                assert np.asarray(g).tobytes() == r.tobytes(), (f, w, g, r)
                continue
            bound = (2 * lens[w] + 4) * U * term_sums(offsets, cols[src])[w]
            if f.startswith("avg"):
                bound = bound / lens[w] + 2 * U * abs(float(r))
            assert abs(float(g) - float(r)) <= bound, (f, w, g, r, bound)


def test_plain_version_adds_in_element_order(windows):
    offsets, cols = windows
    lanes = torch.from_numpy(np.stack([cols["p"], cols["q"]], axis=1))
    s, mx, mn, counts = ek.segment_lanes(
        torch.from_numpy(offsets), lanes, lanes, lanes)
    assert counts.dtype == torch.int32
    assert counts.tolist() == LENGTHS
    for w in range(len(LENGTHS)):
        acc = np.zeros(2, np.float32)
        with np.errstate(invalid="ignore"):      # inf + -inf is NaN here
            for x in lanes[offsets[w]:offsets[w + 1]].numpy():
                acc = (acc + x).astype(np.float32)
        assert s[w].numpy().tobytes() == acc.tobytes()


def test_nan_and_signed_zero_rules(windows):
    offsets, cols = windows
    q = torch.from_numpy(cols["q"])[:, None].contiguous()
    _, mx, mn, _ = ek.segment_lanes(torch.from_numpy(offsets), q, q, q)
    bits = lambda t, w: int(t[w, 0].view(torch.int32)) & 0xFFFFFFFF  # noqa: E731
    assert bits(mx, 1) == bits(mn, 1) == 0x7FC00005
    assert bits(mx, 2) == bits(mn, 2) == 0xFFC0004D
    assert bits(mx, 4) == 0 and bits(mn, 4) == 0x80000000      # +0 > -0
    assert bits(mx, 10) == bits(mn, 10) == 0x80000000
    assert float(mx[8, 0]) == np.inf and float(mn[8, 0]) == -np.inf
    # several NaNs: the max keeps the last, the min the first
    two = torch.tensor([[1.0], [nan_bits(0, 1)], [2.0], [nan_bits(1, 2)]])
    _, mx2, mn2, _ = ek.segment_lanes(torch.tensor([0, 4]), two, two, two)
    assert bits(mx2, 0) == 0xFFC00002 and bits(mn2, 0) == 0x7FC00001


def test_empty_lanes_and_empty_segments():
    z = torch.zeros((7, 0), dtype=torch.float32)
    s, mx, mn, counts = ek.segment_lanes(torch.tensor([0, 3, 3, 7]), z, z, z)
    assert counts.tolist() == [3, 0, 4]
    assert s.shape == mx.shape == mn.shape == (3, 0)
    one = torch.ones((2, 1))
    s, mx, mn, counts = ek.segment_lanes(torch.tensor([0, 0, 2]), one, one, one)
    assert s[:, 0].tolist() == [0.0, 2.0] and counts.tolist() == [0, 2]
    assert mx[0, 0] == -np.inf and mn[0, 0] == np.inf


def test_bad_offsets_raise():
    x = torch.ones((4, 1))
    with pytest.raises(IndexError, match="segment_lanes"):
        ek.segment_lanes(torch.tensor([0, 5]), x, x, x)
    with pytest.raises(IndexError, match="segment_lanes"):
        ek.segment_lanes(torch.tensor([0, 3, 2]), x, x, x)
    with pytest.raises(TypeError):
        ek.segment_lanes(torch.tensor([0, 2], dtype=torch.int32), x, x, x)


def test_cpu_tensors_take_the_plain_version():
    wk.reset_launch_counts()
    x = torch.ones((3, 1))
    ek.segment_lanes(torch.tensor([0, 3]), x, x, x)
    assert wk.LAUNCHES["segment_lanes"] == 0


def test_launch_constants_match_the_source():
    """The kernel's staging and argument block as the wrapper mirrors
    them, and the wrapper's choice of lanes a segment: 8 where the drain's
    mean segment is short (job E's windows of up to 100 elements), a warp
    where it is long (job E2's prefixes) or where a row is too wide for a
    group's share of a stage; rows too wide for a warp's share raise."""
    path = os.path.join(os.path.dirname(ek.__file__), "csrc",
                        "element_kernels.cu")
    with open(path) as f:
        src = f.read()
    assert f"constexpr int kSegStage = {ek.SEGMENT_STAGE};" in src
    sig = re.search(r"int ek_segment_lanes\((.*?)\) \{", src, re.S).group(1)
    assert sig.count(",") == ek._SEGMENT_LANES._struct.size // 8 == 15
    assert "if (group == 8)" in src and "if (group == 32)" in src
    assert ek.segment_group(10_000, 750_000, 2) == 8
    assert ek.segment_group(40, 80_000, 2) == 32
    mean = ek.SEGMENT_WARP_MEAN
    assert ek.segment_group(10, 10 * mean, 3) == 8
    assert ek.segment_group(10, 10 * mean + 1, 3) == 32
    assert ek.segment_group(10_000, 10_000, ek.SEGMENT_STAGE // 4 + 1) == 32
    with pytest.raises(ValueError, match="lane columns"):
        ek.segment_group(1, 1, ek.SEGMENT_STAGE + 1)
