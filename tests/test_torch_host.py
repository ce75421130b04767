"""Parity of the port's host-side modules with their JAX-package
counterparts on the same seeded inputs (all exact): the key hash and
key directory, the window plan's pane math, the window assigners, the
watermark generators and tracker, and the processing-time clock."""
import numpy as np
import pytest

from flink_tpu.api import windowing as jax_windowing
from flink_tpu.ops.window import WindowPlan as JaxWindowPlan
from flink_tpu.records import hash_keys_numpy as jax_hash
from flink_tpu.state.keyed import KeyDirectory as JaxKeyDirectory
from flink_tpu.time import clock as jax_clock
from flink_tpu.time import watermarks as jax_wm
from flink_tpu_torch.api import windowing
from flink_tpu_torch.ops.window import WindowPlan
from flink_tpu_torch.records import hash_keys_numpy
from flink_tpu_torch.state.keyed import KeyDirectory
from flink_tpu_torch.time import clock
from flink_tpu_torch.time import watermarks as wm
from test_torch_threads import capped_torch_threads  # noqa: F401

ASSIGNERS = [
    ("SlidingEventTimeWindows", (10_000, 1_000)),
    ("SlidingEventTimeWindows", (6_000, 4_000, 500)),
    ("TumblingEventTimeWindows", (1_000,)),
    ("TumblingEventTimeWindows", (60_000, 7)),
]


def test_hash_keys_matches_reference():
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(-2**62, 2**62, 10_000),
                           np.arange(-5, 5)]).astype(np.int64)
    np.testing.assert_array_equal(hash_keys_numpy(keys), jax_hash(keys))


def test_key_directory_assigns_the_reference_slots():
    """Same keys in the same batches → the same slots, FULL markers,
    reverse map and snapshot arrays."""
    rng = np.random.default_rng(1)
    ours, theirs = KeyDirectory(8, 32), JaxKeyDirectory(8, 32)
    for _ in range(6):
        keys = rng.integers(0, 400, 3000).astype(np.int64)
        np.testing.assert_array_equal(ours.assign(keys), theirs.assign(keys))
    assert (ours.assign(np.arange(400)) == KeyDirectory.FULL).any()
    assert ours.num_keys() == theirs.num_keys()
    a, b = ours.snapshot(), theirs.snapshot()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    restored = KeyDirectory.restore(8, 32, b)
    keys = rng.integers(0, 400, 500)
    np.testing.assert_array_equal(restored.assign(keys), theirs.assign(keys))


@pytest.mark.parametrize("name,args", ASSIGNERS)
@pytest.mark.parametrize("lateness,ooo", [(0, 0), (2_000, 1_000)])
def test_window_plan_matches_reference(name, args, lateness, ooo):
    """Ring size, dead/fired frontiers, fire-end enumeration and late
    re-fire ends over random watermarks."""
    ours = WindowPlan.plan(getattr(windowing, name).of(*args),
                           allowed_lateness_ms=lateness,
                           max_out_of_orderness_ms=ooo)
    theirs = JaxWindowPlan.plan(getattr(jax_windowing, name).of(*args),
                                allowed_lateness_ms=lateness,
                                max_out_of_orderness_ms=ooo)
    assert dataclass_tuple(ours) == dataclass_tuple(theirs)
    rng = np.random.default_rng(len(args) + lateness)
    prev = wm.LONG_MIN
    for w in np.sort(rng.integers(-50_000, 500_000, 40)).tolist():
        lo, hi = int(rng.integers(-100, 100)), int(rng.integers(100, 600))
        for f in ("first_dead_pane", "fire_frontier", "final_watermark_for"):
            args_ = (w,) if f != "final_watermark_for" else (w, hi)
            assert getattr(ours, f)(*args_) == getattr(theirs, f)(*args_)
        assert ours.enumerate_fire_ends(prev, w, lo, hi) == \
            theirs.enumerate_fire_ends(prev, w, lo, hi)
        late = rng.integers(lo, hi, 20)
        fired = ours.fire_frontier(w)
        assert ours.late_refire_ends(late, fired, w) == \
            theirs.late_refire_ends(late, fired, w)
        prev = w


def dataclass_tuple(plan):
    return (plan.pane_ms, plan.offset_ms, plan.size_ms, plan.slide_ms,
            plan.panes_per_window, plan.panes_per_slide, plan.ring,
            plan.allowed_lateness_ms)


@pytest.mark.parametrize("name,args", ASSIGNERS)
def test_assigners_match_reference(name, args):
    ours = getattr(windowing, name).of(*args)
    theirs = getattr(jax_windowing, name).of(*args)
    for attr in ("pane_ms", "size_ms", "slide_ms", "offset_ms",
                 "panes_per_window", "panes_per_slide"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    for t in np.random.default_rng(3).integers(-10**6, 10**7, 50).tolist():
        assert ours.pane_index(t) == theirs.pane_index(t)
        assert [(w.start, w.end) for w in ours.assign_windows(t)] == \
            [(w.start, w.end) for w in theirs.assign_windows(t)]
        e = ours.pane_index(t) + 3
        w1, w2 = ours.window_for_end_pane(e), theirs.window_for_end_pane(e)
        assert (w1.start, w1.end, w1.max_timestamp()) == \
            (w2.start, w2.end, w2.max_timestamp())


@pytest.mark.parametrize("ooo", [0, 1_000])
def test_watermark_generators_and_tracker_match_reference(ooo):
    rng = np.random.default_rng(ooo)
    ours = wm.make_generator(wm.WatermarkStrategy.for_bounded_out_of_orderness(ooo))
    theirs = jax_wm.make_generator(
        jax_wm.WatermarkStrategy.for_bounded_out_of_orderness(ooo))
    assert ours.current() == theirs.current() == wm.LONG_MIN
    t_ours, t_theirs = wm.WatermarkTracker(), jax_wm.WatermarkTracker()
    for iid in ("a", "b", "c"):
        t_ours.register_input(iid)
        t_theirs.register_input(iid)
    for _ in range(60):
        ts = int(rng.integers(0, 10**6))
        assert ours.on_batch(ts) == theirs.on_batch(ts)
        iid = "abc"[int(rng.integers(0, 3))]
        idle = bool(rng.random() < 0.2)
        w = int(rng.integers(-1000, 10**6))
        assert t_ours.update(iid, w, idle) == t_theirs.update(iid, w, idle)


def test_manual_clock_matches_reference():
    ours, theirs = (clock.ManualProcessingTimeService(5),
                    jax_clock.ManualProcessingTimeService(5))
    for step in (0, 7, 100):
        ours.advance_by(step)
        theirs.advance_by(step)
        assert ours.now_ms() == theirs.now_ms()
    with pytest.raises(ValueError):
        ours.advance_to(0)
    assert abs(clock.SystemProcessingTimeService().now_ms()
               - jax_clock.SystemProcessingTimeService().now_ms()) < 60_000
