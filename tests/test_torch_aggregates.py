"""The port's lane aggregates against ``flink_tpu.ops.aggregates``: the
same numpy record fields, lifted (masked) and finalized by both; every
lane and result must be equal bit for bit (lifts are casts and copies,
finalizes a select or one f32 division), NaN and signed zeros
included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import aggregates as ja
from flink_tpu_torch.ops import aggregates as ta
from test_torch_threads import capped_torch_threads  # noqa: F401

B = 257


def _data(rng):
    price = (rng.standard_normal(B) * 300).astype(np.float32)
    price[:4] = [np.nan, -0.0, 0.0, np.inf]
    return {"price": price,
            "bid": rng.integers(-10**6, 10**6, B).astype(np.int64),
            "w": rng.standard_normal(B)}   # float64, as a map could emit


def _both(build):
    return build(ja), build(ta)


CASES = {
    "count": lambda m: m.count(),
    "count_named": lambda m: m.count("n"),
    "sum": lambda m: m.sum_of("price"),
    "sum_int": lambda m: m.sum_of("bid", "total"),
    "max": lambda m: m.max_of("price"),
    "min": lambda m: m.min_of("bid"),
    "avg": lambda m: m.avg_of("price"),
    "multi": lambda m: m.multi(m.count(), m.sum_of("price"), m.max_of("price"),
                               m.min_of("price")),
    "multi_avg": lambda m: m.multi(m.count(), m.avg_of("w"), m.max_of("bid")),
}


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("case", sorted(CASES))
def test_lift_masked_and_finalize_match_reference(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    ref, port = _both(CASES[case])
    assert (port.sum_width, port.max_width, port.min_width) == \
        (ref.sum_width, ref.max_width, ref.min_width)
    assert port.fields == ref.fields and port.sum_fields == ref.sum_fields
    assert port.name == ref.name
    data = _data(rng)
    valid = rng.random(B) < 0.7
    # the operators upload device_cast fields: f64 becomes f32
    from flink_tpu.records import device_cast as jax_cast
    from flink_tpu_torch.records import device_cast

    fields = ref.fields
    rl = ref.lift_masked({k: jnp.asarray(jax_cast(data[k])) for k in fields},
                         jnp.asarray(valid))
    pl = port.lift_masked({k: torch.from_numpy(device_cast(data[k]))
                           for k in fields}, torch.from_numpy(valid))
    for r, p in zip(rl, pl):
        assert p.dtype == torch.float32 and tuple(p.shape) == r.shape
        np.testing.assert_array_equal(_bits(p.numpy()), _bits(r))
    # finalize over lanes as a fire reads them, counts with zeros
    lanes = [np.array(x) for x in rl]
    counts = rng.integers(0, 5, B).astype(np.int32)
    rres = ref.finalize(*(jnp.asarray(x) for x in lanes), jnp.asarray(counts))
    pres = port.finalize(*(torch.from_numpy(x) for x in lanes),
                         torch.from_numpy(counts))
    assert sorted(pres) == sorted(rres)
    for k in rres:
        r = np.asarray(rres[k])
        p = pres[k].numpy()
        assert p.dtype == r.dtype, k
        np.testing.assert_array_equal(_bits(p), _bits(r))
    assert ta.result_fields(port) == ja.result_fields(ref)


def test_probe_finalize_types_match_reference():
    for case in sorted(CASES):
        ref, port = _both(CASES[case])
        rp, pp = ja.probe_finalize(ref), ta.probe_finalize(port)
        assert sorted(rp) == sorted(pp)
        for k in rp:
            assert pp[k].numpy().dtype == np.asarray(rp[k]).dtype, (case, k)


def test_lift_with_wrong_width_raises():
    bad = ta.LaneAggregate(1, 0, 0, lambda d: (d["x"][:, None].repeat(1, 2),
                                               None, None),
                           lambda s, m, n, c: {"c": c}, name="bad",
                           fields=("x",))
    with pytest.raises(ValueError, match="expected"):
        bad.lift_masked({"x": torch.zeros(3)}, torch.ones(3, dtype=torch.bool))


def test_windowed_stream_shortcuts_build_the_builtins():
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows

    env = StreamExecutionEnvironment()
    w = env.from_collection({"k": np.zeros(1, np.int64)}, np.zeros(1)) \
        .key_by("k").window(TumblingEventTimeWindows.of(10))
    assert w.sum("p").transform.aggregate is ta.sum_of("p")
    assert w.max("p").transform.aggregate is ta.max_of("p")
    assert w.min("p").transform.aggregate is ta.min_of("p")
    assert w.count().transform.aggregate is ta.count()
