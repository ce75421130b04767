"""CEP (``cep.py``: ``Pattern``, ``CepOperator``, ``CEP.pattern``) in the
port, against the JAX package on the same inputs: the semantics of
``tests/test_cep.py`` — strict and relaxed contiguity, ``within``, both
negations and the trailing absence window, the three after-match modes,
the quantifiers, the batch-atomic rollback of a partial-buffer overflow
(the operator's state compared field by field after the error), the
pattern builder's refusals, a job through ``env.execute``, and snapshots
restored across the packages.

Each case builds its pattern in both packages from one builder, feeds
both operators the same numpy input once, and compares every emitted
column exactly and in order (keys, stage timestamps, match bounds,
counts: all integers); then holds the rows to the reference test's
expected values or to its scalar oracle (``tests/test_cep.py``)."""
import types

import numpy as np
import pytest

import test_cep as ref
from test_torch_ckpt_pkgs import BOTH, JAX, PORT, pkg_id
from test_torch_threads import capped_torch_threads  # noqa: F401

both = pytest.mark.parametrize("P", BOTH, ids=pkg_id)


def _cep(P):
    if P is PORT:
        from flink_tpu_torch import cep
    else:
        from flink_tpu import cep
    return types.SimpleNamespace(Pattern=cep.Pattern, Op=cep.CepOperator,
                                 CEP=cep.CEP)


C = {P.name: _cep(P) for P in BOTH}


# -- the patterns, one builder each for both packages -------------------------------

def small_large(Pt, within=None):
    p = (Pt.begin("small").where(lambda d: d["amount"] < 10)
         .followed_by("large").where(lambda d: d["amount"] > 500))
    return p.within(within) if within else p


def strict_ab(Pt):
    return (Pt.begin("a").where(lambda d: d["amount"] < 10)
            .next("b").where(lambda d: d["amount"] > 500))


def v_eq(n):
    return lambda d: d["v"] == n


def ab(Pt, mode=None, ref_stage=None, strict=False):
    p = Pt.begin("a").where(v_eq(0))
    p = (p.next("b") if strict else p.followed_by("b")).where(v_eq(1))
    return p.after_match(mode, ref_stage) if mode else p


def absence(Pt):
    return (Pt.begin("a").where(v_eq(1))
            .followed_by("b").where(v_eq(2))
            .not_followed_by("c").where(v_eq(3))
            .within(100))


def quantified(Pt, variant):
    if variant == 0:
        return (Pt.begin("a").where(lambda d: d["v"] < 3)
                .followed_by("b").where(lambda d: d["v"] >= 7).times(2)
                .within(50))
    if variant == 1:
        return (Pt.begin("a").where(lambda d: d["v"] < 3).one_or_more()
                .followed_by("b").where(lambda d: d["v"] >= 7))
    return (Pt.begin("a").where(lambda d: d["v"] < 3)
            .followed_by("b").where(lambda d: (d["v"] >= 3) & (d["v"] < 5))
            .optional()
            .followed_by("c").where(lambda d: d["v"] >= 7))


def negated(Pt, variant):
    if variant == 0:
        return (Pt.begin("a").where(lambda d: d["v"] < 3)
                .not_followed_by("nb").where(lambda d: (d["v"] >= 3)
                                             & (d["v"] < 5))
                .followed_by("c").where(lambda d: d["v"] >= 7).within(80))
    if variant == 1:
        return (Pt.begin("a").where(lambda d: d["v"] < 3)
                .not_next("nn").where(lambda d: (d["v"] == 5)
                                      | (d["v"] == 6))
                .followed_by("c").where(lambda d: d["v"] >= 7).within(60))
    return (Pt.begin("a").where(lambda d: d["v"] < 3)
            .followed_by("b").where(lambda d: d["v"] >= 7)
            .not_followed_by("nc").where(lambda d: (d["v"] >= 3)
                                         & (d["v"] < 5))
            .within(50))


def abc(Pt, mode, ref_stage=None):
    return (Pt.begin("a").where(lambda d: d["v"] % 3 == 0)
            .followed_by("b").where(lambda d: d["v"] % 3 == 1)
            .followed_by("c").where(lambda d: d["v"] % 3 == 2)
            .within(40).after_match(mode, ref_stage))


# -- running a case in both packages ---------------------------------------------------

def batch(keys, ts, field, vals):
    return ("batch", np.asarray(keys, np.int64), np.asarray(ts, np.int64),
            {field: np.asarray(vals)})


def events_batch(events):
    """``tests/test_cep.py``'s (key, ts, {field: value}) events as one
    batch."""
    fields = {f: np.asarray([e[2][f] for e in events]) for f in events[0][2]}
    return ("batch", np.asarray([e[0] for e in events], np.int64),
            np.asarray([e[1] for e in events], np.int64), fields)


def run(P, build, steps, shards=8, slots=64):
    """Feed one package's operator the steps (a batch, then its matches;
    ``("wm", w)``: a watermark advance; ``("final",)``: the end-of-input
    advance); each step's emitted columns (None when nothing)."""
    op = C[P.name].Op(build(C[P.name].Pattern), num_shards=shards,
                      slots_per_shard=slots)
    outs = []
    for st in steps:
        if st[0] == "batch":
            op.process_batch(st[1], st[2], st[3])
            f = op.take_fired()
        else:
            wm = op.final_watermark() if st[0] == "final" else st[1]
            f = op.advance_watermark(wm)
        d = None if f is None else {k: np.asarray(v) for k, v in dict(f).items()}
        outs.append(d if d is not None and len(d["__ts__"]) else None)
    return outs, op


def same_columns(a, b):
    """Two emissions, column by column: names, dtypes and values."""
    assert (a is None) == (b is None), (a, b)
    if a is None:
        return
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def run_both(build, steps, **kw):
    """The port's emissions, after holding them to the reference's."""
    port, pop = run(PORT, build, steps, **kw)
    jax_, jop = run(JAX, build, steps, **kw)
    assert len(port) == len(jax_)
    for a, b in zip(port, jax_):
        same_columns(a, b)
    assert pop.late_records == jop.late_records
    return port, pop


def rows(outs, *cols):
    """Every emission's rows as tuples of ``cols``, in emission order."""
    out = []
    for d in outs:
        if d is not None:
            out += zip(*(map(int, d[c]) for c in cols))
    return out


def se(outs):
    return sorted(rows(outs, "key", "match_start", "match_end"))


# -- contiguity, within, skip-past-last, late events ---------------------------------

OPERATOR_CASES = {
    "relaxed_skips_intervening": (
        small_large, [batch([1] * 4, [10, 20, 30, 40], "amount",
                            [5, 100, 200, 600])],
        ("small", "large"), [[(1, 10, 40)]]),
    "strict_next_requires_adjacency": (
        strict_ab, [batch([1] * 3, [10, 20, 30], "amount", [5, 100, 600]),
                    batch([2, 2], [10, 20], "amount", [5, 600])],
        ("a", "b"), [[], [(2, 10, 20)]]),
    "strict_break_restarts_on_breaking_event": (
        strict_ab, [batch([1] * 3, [10, 20, 30], "amount", [5, 3, 600])],
        ("a", "b"), [[(1, 20, 30)]]),
    "within_expires_partial": (
        lambda Pt: small_large(Pt, within=1000),
        [batch([1, 1], [10, 2000], "amount", [5, 600]),
         batch([1, 1], [3000, 3500], "amount", [5, 600])],
        ("small", "large"), [[], [(1, 3000, 3500)]]),
    "skip_past_last_no_overlap": (
        small_large, [batch([1] * 4, [10, 20, 30, 40], "amount",
                            [5, 6, 600, 700])],
        ("small", "large"), [[(1, 10, 30)]]),
    "cross_batch_partials": (
        small_large, [batch([7], [100], "amount", [5]),
                      batch([7], [200], "amount", [900])],
        ("small", "large"), [[], [(7, 100, 200)]]),
    "cross_batch_out_of_order_drops_with_accounting": (
        small_large, [batch([1], [200], "amount", [5]),
                      batch([1], [100], "amount", [700]),
                      batch([1], [300], "amount", [700])],
        ("small", "large"), [[], [], [(1, 200, 300)]]),
}


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_operator_semantics(case):
    build, steps, (a, b), want = OPERATOR_CASES[case]
    outs, op = run_both(build, steps, shards=4, slots=16)
    assert [sorted(rows([o], "key", f"{a}_ts", f"{b}_ts")) for o in outs] \
        == want
    assert op.late_records == (1 if "out_of_order" in case else 0)


def test_many_keys_in_ragged_batches_against_brute_force():
    """200 keys, 4,000 events in batches of 500, within 5 s: every
    batch's matches equal the reference's, and all of them the brute
    force of the documented semantics (one partial a key)."""
    rng = np.random.default_rng(11)
    K, N = 200, 4000
    keys = rng.integers(0, K, N)
    ts = np.arange(N) * 3
    amounts = np.where(rng.random(N) < 0.2, rng.uniform(0, 9, N),
                       np.where(rng.random(N) < 0.1, rng.uniform(501, 900, N),
                                rng.uniform(20, 400, N)))
    steps = [batch(keys[c:c + 500], ts[c:c + 500], "amount",
                   amounts[c:c + 500]) for c in range(0, N, 500)]
    outs, _ = run_both(lambda Pt: small_large(Pt, within=5000), steps)
    want, state = [], {}
    for k, t, a in zip(keys.tolist(), ts.tolist(), amounts.tolist()):
        st = state.get(k)
        if st is not None and t - st > 5000:
            st = None
        if st is None:
            if a < 10:
                state[k] = t
        elif a > 500:
            want.append((k, st, t))
            state[k] = None
    assert sorted(rows(outs, "key", "small_ts", "large_ts")) == sorted(want)
    assert len(want) > 50


# -- quantifiers ---------------------------------------------------------------------

def test_times_expands_and_matches():
    def build(Pt):
        return (Pt.begin("small").where(lambda d: d["amount"] < 10)
                .followed_by("large").where(lambda d: d["amount"] > 500)
                .times(2))
    outs, op = run_both(build, [batch([1] * 4, [0, 10, 20, 30], "amount",
                                      [5, 600, 700, 800])])
    assert se(outs) == [(1, 0, 20)]
    assert [s.name for s in op.stages] == ["small", "large_1", "large_2"]
    assert rows(outs, "large_1_ts", "large_2_ts") == [(10, 20)]


@pytest.mark.parametrize("events,want", [
    ([(1, 0, 1), (1, 1, 2), (1, 2, 2)], [(1, 0, 2)]),
    ([(2, 0, 1), (2, 1, 2), (2, 2, 9), (2, 3, 2)], []),
], ids=["consecutive", "broken"])
def test_times_strict_consecutive(events, want):
    def build(Pt):
        return (Pt.begin("a").where(v_eq(1))
                .next("b").where(v_eq(2)).times(2))
    outs, _ = run_both(build, [batch(*zip(*[(k, t) for k, t, _ in events]),
                                     "v", [v for *_, v in events])])
    assert se(outs) == want


def test_one_or_more_greedy_counts():
    def build(Pt):
        return (Pt.begin("up").where(lambda d: d["v"] > 0).one_or_more()
                .followed_by("down").where(lambda d: d["v"] < 0))
    outs, _ = run_both(build, [batch([1] * 4, [0, 10, 20, 30], "v",
                                     [1, 2, 3, -1])])
    assert rows(outs, "up_count", "up_ts", "up_last_ts", "down_ts") == \
        [(3, 0, 20, 30)]


@pytest.mark.parametrize("events,want_b,want_c", [
    ([(1, 0, 1), (1, 1, 2), (1, 2, 3)], 1, 2),
    ([(2, 0, 1), (2, 1, 3)], -1, 1),
], ids=["present", "absent"])
def test_optional_present_and_absent(events, want_b, want_c):
    def build(Pt):
        return (Pt.begin("a").where(v_eq(1))
                .followed_by("b").where(v_eq(2)).optional()
                .followed_by("c").where(v_eq(3)))
    outs, _ = run_both(build, [batch(*zip(*[(k, t) for k, t, _ in events]),
                                     "v", [v for *_, v in events])])
    assert rows(outs, "b_ts", "c_ts") == [(want_b, want_c)]


def random_events(seed, n=400, keys=12, span=3000):
    """``tests/test_cep.py``'s property streams: unique (key, ts) pairs
    in time order, v in 0..9."""
    rng = np.random.default_rng(seed)
    events = [(int(k), int(t), {"v": int(v)})
              for k, t, v in zip(rng.integers(0, keys, n),
                                 np.sort(rng.integers(0, span, n)),
                                 rng.integers(0, 10, n))]
    seen = set()
    return [e for e in events
            if (e[0], e[1]) not in seen and not seen.add((e[0], e[1]))]


@pytest.mark.parametrize("seed", range(5))
def test_quantifiers_against_the_scalar_oracle(seed):
    build = lambda Pt: quantified(Pt, seed % 3)  # noqa: E731
    events = random_events(seed)
    outs, op = run_both(build, [events_batch(events)])
    assert se(outs) == ref.scalar_oracle(op.stages, op.pattern.within_ms,
                                         events)


# -- the builder's refusals ------------------------------------------------------------

REFUSALS = {
    "trailing_one_or_more": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0)
        .one_or_more().stages, "trailing one_or_more"),
    "trailing_optional": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0)
        .followed_by("b").where(lambda d: d["v"] < 0).optional().stages,
        "trailing optional"),
    "optional_first": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0).optional()
        .followed_by("b").where(lambda d: d["v"] < 0).stages,
        "first stage"),
    "next_after_loop": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0).one_or_more()
        .next("b").where(lambda d: d["v"] < 0).stages, "followed_by"),
    "strict_loop": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0)
        .next("b").where(lambda d: d["v"] < 0).one_or_more(),
        "relaxed contiguity"),
    "absence_without_within": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0)
        .not_followed_by("b").where(lambda d: d["v"] < 0).stages,
        "needs within"),
    "trailing_not_next": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0)
        .not_next("b").where(lambda d: d["v"] < 0).stages,
        "trailing not_next"),
    "next_after_negation": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0)
        .not_followed_by("b").where(lambda d: d["v"] < 0)
        .next("c").where(lambda d: d["v"] == 0).stages, "followed_by"),
    "adjacent_negations": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0)
        .not_followed_by("b").where(lambda d: d["v"] < 0)
        .not_followed_by("c").where(lambda d: d["v"] == 0)
        .within(10).stages, "adjacent negated"),
    "quantified_negation": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0)
        .not_followed_by("b").where(lambda d: d["v"] < 0).times(2),
        "cannot be quantified"),
    "negation_after_quantifier": (
        lambda Pt: Pt.begin("a").where(lambda d: d["v"] > 0).one_or_more()
        .not_followed_by("b").where(lambda d: d["v"] < 0)
        .followed_by("c").where(lambda d: d["v"] == 0).stages,
        "quantified stage"),
    "skip_to_without_stage": (
        lambda Pt: ab(Pt).after_match("SKIP_TO_FIRST"),
        "needs the stage name"),
    "no_skip_with_stage": (
        lambda Pt: ab(Pt).after_match("NO_SKIP", "b"),
        "takes no stage name"),
    "unknown_mode": (
        lambda Pt: ab(Pt).after_match("SKIP_TO_NEXT"), "supported modes"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_builder_refuses_what_the_reference_refuses(case):
    build, msg = REFUSALS[case]
    for P in BOTH:
        with pytest.raises(ValueError, match=msg):
            build(C[P.name].Pattern)


OPERATOR_REFUSALS = {
    "missing_where": (
        lambda Pt: Pt.begin("a").where(lambda d: d["amount"] < 10).next("b"),
        ValueError, "has no where"),
    "no_skip_quantifier": (
        lambda Pt: Pt.begin("a").where(v_eq(0))
        .followed_by("b").where(v_eq(1)).one_or_more()
        .followed_by("c").where(v_eq(2)).after_match("NO_SKIP"),
        NotImplementedError, "NO_SKIP"),
    "no_skip_negation": (
        lambda Pt: Pt.begin("a").where(v_eq(0))
        .not_followed_by("x").where(v_eq(5))
        .followed_by("b").where(v_eq(1)).after_match("NO_SKIP"),
        NotImplementedError, "negated"),
    "unknown_skip_stage": (
        lambda Pt: ab(Pt, "SKIP_TO_FIRST", "zz"), ValueError,
        "no stage named"),
}


@pytest.mark.parametrize("case", sorted(OPERATOR_REFUSALS))
def test_the_operator_refuses_what_the_reference_refuses(case):
    build, exc, msg = OPERATOR_REFUSALS[case]
    for P in BOTH:
        with pytest.raises(exc, match=msg):
            C[P.name].Op(build(C[P.name].Pattern), num_shards=4,
                         slots_per_shard=64)


# -- negation and the trailing absence window -----------------------------------------

def test_not_followed_by_mid_pattern():
    def build(Pt):
        return (Pt.begin("a").where(v_eq(1))
                .not_followed_by("b").where(v_eq(2))
                .followed_by("c").where(v_eq(3)))
    outs, _ = run_both(build, [batch([1, 1, 1, 2, 2, 2],
                                     [10, 20, 30, 10, 20, 30], "v",
                                     [1, 9, 3, 1, 2, 3])])
    assert rows(outs, "key", "b_ts", "c_ts") == [(1, -1, 30)]


def test_an_event_matching_both_counts_as_the_next_stage():
    def build(Pt):
        return (Pt.begin("a").where(v_eq(1))
                .not_followed_by("b").where(lambda d: d["v"] >= 3)
                .followed_by("c").where(v_eq(3)))
    outs, _ = run_both(build, [batch([1, 1], [10, 20], "v", [1, 3]),
                               ("final",)])
    assert se(outs) == [(1, 10, 20)]


def test_not_next_kills_on_adjacent_only():
    def build(Pt):
        return (Pt.begin("a").where(v_eq(1))
                .not_next("b").where(v_eq(2))
                .followed_by("c").where(v_eq(3)))
    outs, _ = run_both(build, [batch(
        [1, 1, 1, 2, 2, 2, 3, 3], [10, 20, 30, 10, 20, 30, 10, 20], "v",
        [1, 2, 3, 1, 9, 3, 1, 3]), ("final",)])
    assert se(outs) == [(2, 10, 30), (3, 10, 20)]


def test_trailing_absence_fires_on_the_watermark():
    outs, _ = run_both(absence, [
        batch([1, 1, 1, 2, 2], [10, 20, 50, 10, 20], "v", [1, 2, 3, 1, 2]),
        ("wm", 105), ("wm", 110), ("wm", 500)])
    assert outs[0] is None and outs[1] is None and outs[3] is None
    assert se([outs[2]]) == [(2, 10, 110)]
    assert rows([outs[2]], "c_ts") == [(-1,)]


def test_trailing_absence_completes_in_stream():
    outs, _ = run_both(absence, [batch([7, 7], [10, 20], "v", [1, 2]),
                                 batch([7], [300], "v", [9])])
    assert outs[0] is None
    assert rows([outs[1]], "key", "match_end") == [(7, 110)]


@pytest.mark.parametrize("seed", range(6))
def test_negation_against_the_scalar_oracle(seed):
    """Random keyed streams over negated patterns, with the end-of-input
    absence flush."""
    build = lambda Pt: negated(Pt, seed % 3)  # noqa: E731
    events = random_events(100 + seed)
    outs, op = run_both(build, [events_batch(events), ("final",)])
    assert se(outs) == ref.scalar_oracle(op.stages, op.pattern.within_ms,
                                         events)


# -- the multi-partial engine: NO_SKIP, SKIP_TO_FIRST / SKIP_TO_LAST ------------------

@pytest.mark.parametrize("strict,want", [
    (False, [(1, 10, 30), (1, 20, 30)]),
    (True, [(1, 20, 30)]),
], ids=["overlapping_matches_enumerated", "strict_kills_only_that_partial"])
def test_no_skip(strict, want):
    outs, _ = run_both(lambda Pt: ab(Pt, "NO_SKIP", strict=strict),
                       [batch([1, 1, 1], [10, 20, 30], "v", [0, 0, 1])])
    assert se(outs) == want


@pytest.mark.parametrize("seed,mode,stage", [
    (11, "NO_SKIP", None),
    (200, "SKIP_TO_FIRST", "b"), (201, "SKIP_TO_LAST", "b"),
    (202, "SKIP_TO_FIRST", "c"), (203, "SKIP_TO_LAST", "a"),
])
def test_multi_partial_against_the_oracle(seed, mode, stage):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 5, 200)
    ts = np.sort(rng.integers(0, 400, 200))
    v = rng.integers(0, 9, 200)
    outs, op = run_both(lambda Pt: abc(Pt, mode, stage),
                        [batch(keys, ts, "v", v)], shards=4)
    if mode == "NO_SKIP":
        want = ref.TestNoSkip._oracle(op.stages, keys, ts, {"v": v},
                                      within=40)
    else:
        want = ref.TestSkipToStrategies._oracle(
            op.stages, keys, ts, {"v": v}, within=40, ref=op._skip_ref)
    assert se(outs) == want and want


@pytest.mark.parametrize("stage,want", [
    ("b", [(1, 10, 30)]), ("a", [(1, 10, 30), (1, 20, 30)])])
def test_skip_to_first_prunes_earlier_starts(stage, want):
    outs, _ = run_both(lambda Pt: ab(Pt, "SKIP_TO_FIRST", stage),
                       [batch([1, 1, 1], [10, 20, 30], "v", [0, 0, 1])])
    assert se(outs) == want


@pytest.mark.parametrize("mode,ix", [("SKIP_TO_LAST", 2),
                                     ("SKIP_TO_FIRST", 1)])
def test_skip_to_resolves_the_times_expansion(mode, ix):
    def build(Pt):
        return (Pt.begin("a").where(v_eq(0))
                .followed_by("b").where(v_eq(1)).times(2)
                .after_match(mode, "b"))
    for P in BOTH:
        op = C[P.name].Op(build(C[P.name].Pattern), num_shards=4,
                          slots_per_shard=64)
        assert [s.name for s in op.stages] == ["a", "b_1", "b_2"]
        assert op._skip_ref == ix


# -- the overflow rollback ----------------------------------------------------------------

def flood():
    """Batch 1 leaves live partials (two of key 1, one of key 2); batch
    2 floods key 1 past the partial budget and carries a completion of
    key 2 and earlier in-batch matches of key 1."""
    n = 8 + 1
    return (batch([1, 1, 2], [10, 20, 30], "v", [0, 0, 0]),
            batch([1] * n + [2], np.arange(100, 101 + n), "v",
                  [0] * n + [1]))


def state_fields(op):
    return {k: v for k, v in op.snapshot_state().items()
            if isinstance(v, np.ndarray)}


def test_overflow_is_loud_and_rolls_back_field_by_field():
    """The overflow error leaves each package's operator exactly as it
    was before the batch: every state array equal, field by field, to
    its value before, and to the other package's; no match leaks."""
    first, second = flood()
    after = {}
    for P in BOTH:
        op = C[P.name].Op(ab(C[P.name].Pattern, "NO_SKIP"), num_shards=4,
                          slots_per_shard=64)
        assert op.max_partials == 8
        op.process_batch(*first[1:])
        before = state_fields(op)
        with pytest.raises(RuntimeError, match="partial-buffer overflow"):
            op.process_batch(*second[1:])
        now = state_fields(op)
        assert sorted(now) == sorted(before)
        for k in before:
            assert np.array_equal(now[k], before[k]), (P.name, k)
        assert op.take_fired() is None, "overflow leaked matches"
        after[P.name] = now
    for k in after["jax"]:
        assert np.array_equal(after["port"][k], after["jax"][k]), k


def test_recovery_after_overflow_matches_a_fresh_run():
    good1 = batch([1, 1], [10, 20], "v", [0, 0])
    good2 = batch([1], [200], "v", [1])
    over = batch([1] * 9, np.arange(100, 109), "v", [0] * 9)
    got = {}
    for P in BOTH:
        op = C[P.name].Op(ab(C[P.name].Pattern, "NO_SKIP"), num_shards=4,
                          slots_per_shard=64)
        op.process_batch(*good1[1:])
        with pytest.raises(RuntimeError, match="partial-buffer overflow"):
            op.process_batch(*over[1:])
        op.process_batch(*good2[1:])
        got[P.name] = se([dict(op.take_fired())])
    fresh, _ = run_both(lambda Pt: ab(Pt, "NO_SKIP"), [good1, good2])
    assert got["port"] == got["jax"] == se(fresh) == [(1, 10, 200),
                                                      (1, 20, 200)]


# -- snapshots across the packages -----------------------------------------------------

SNAPSHOT_CASES = {
    "single_partial": (small_large, batch([1], [10], "amount", [5]),
                       [batch([1], [20], "amount", [700])], [(1, 10, 20)]),
    "no_skip_partials": (lambda Pt: ab(Pt, "NO_SKIP"),
                         batch([1, 1], [10, 20], "v", [0, 0]),
                         [batch([1], [30], "v", [1])],
                         [(1, 10, 30), (1, 20, 30)]),
    "pending_absence": (absence, batch([1, 1], [10, 20], "v", [1, 2]),
                        [("wm", 200)], [(1, 10, 110)]),
    "loop_state": (lambda Pt: quantified(Pt, 1),
                   batch([3, 3, 3], [1, 2, 3], "v", [0, 1, 2]),
                   [batch([3], [9], "v", [8])], [(3, 1, 9)]),
}


@pytest.mark.parametrize("case", sorted(SNAPSHOT_CASES))
@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_snapshot_restores_across_the_packages(case, src, dst):
    """One package's snapshot, through the checkpoint blob format,
    restores into the other's operator: its state arrays equal the
    writer's and it completes the pending matches as the writer does."""
    build, first, rest, want = SNAPSHOT_CASES[case]
    a = C[src.name].Op(build(C[src.name].Pattern), num_shards=4,
                       slots_per_shard=16)
    a.process_batch(*first[1:])
    snap = dst.blobformat.decode(src.blobformat.encode(a.snapshot_state()))
    b = C[dst.name].Op(build(C[dst.name].Pattern), num_shards=4,
                       slots_per_shard=16)
    b.restore_state(snap)
    for k, v in state_fields(a).items():
        assert np.array_equal(state_fields(b)[k], v), k
    outs = []
    for op in (a, b):
        o = []
        for st in rest:
            f = (op.take_fired() if st[0] == "batch" and
                 op.process_batch(*st[1:]) is None
                 else op.advance_watermark(st[1]))
            o.append(None if f is None else dict(f))
        outs.append(se(o))
    assert outs[0] == outs[1] == want


# -- a job ----------------------------------------------------------------------------------

def test_pattern_stream_pipeline():
    """``CEP.pattern(stream.key_by('acct'), pattern)`` through
    ``env.execute``: the rows are the reference's, in order."""
    def gen(split, i):
        if i >= 3:
            return None
        data = [([1, 2, 1], [5.0, 800.0, 3.0]),
                ([2, 1, 2], [4.0, 900.0, 2.0]),
                ([1, 2, 2], [600.0, 700.0, 100.0])][i]
        return ({"acct": np.array(data[0], np.int64),
                 "amount": np.array(data[1], np.float64)},
                np.arange(3, dtype=np.int64) + i * 10)

    got = {}
    for P in BOTH:
        env = P.Env(P.Conf({"pipeline.microbatch-size": 8,
                            "state.num-key-shards": 4,
                            "state.slots-per-shard": 16}))
        sink = P.sinks.CollectSink()
        stream = (env.from_source(P.GeneratorSource(gen),
                                  P.WM.for_monotonous_timestamps())
                  .key_by("acct"))
        C[P.name].CEP.pattern(stream, small_large(C[P.name].Pattern)
                              ).add_sink(sink)
        P.execute(env, "cep-e2e")
        got[P.name] = [(int(r["key"]), int(r["small_ts"]),
                        int(r["large_ts"])) for r in sink.rows]
    assert got["port"] == got["jax"] == [(1, 0, 11), (2, 10, 21)]


@pytest.mark.parametrize("width", [4, 12])
def test_a_snapshot_restores_at_another_partial_buffer_width(width):
    """Whether a NO_SKIP snapshot restores at another ``max_partials``
    (the port's option; the reference fixes 8): it does not. The
    reference's 8-wide snapshot restores into the port's 8-wide buffer
    and completes the same matches; a narrower or a wider port operator
    refuses it, and keeps its own state."""
    def build(Pt):
        return ab(Pt, "NO_SKIP")
    a = C["jax"].Op(build(C["jax"].Pattern), num_shards=4,
                    slots_per_shard=16)
    a.process_batch(np.array([1, 1, 2]), np.array([10, 20, 30]),
                    {"v": np.array([0, 0, 0])})
    snap = PORT.blobformat.decode(JAX.blobformat.encode(a.snapshot_state()))
    other = C["port"].Op(build(C["port"].Pattern), num_shards=4,
                         slots_per_shard=16, max_partials=width)
    with pytest.raises(ValueError, match=f"max_partials is {width}"):
        other.restore_state(snap)
    assert other.p_stage.shape[1] == width and (other.p_stage < 0).all()
    b = C["port"].Op(build(C["port"].Pattern), num_shards=4,
                     slots_per_shard=16)
    b.restore_state(snap)
    for op in (a, b):
        op.process_batch(np.array([1, 2]), np.array([40, 50]),
                         {"v": np.array([1, 1])})
    assert se([dict(a.take_fired())]) == se([dict(b.take_fired())]) == [
        (1, 10, 40), (1, 20, 40), (2, 30, 50)]


def test_max_partials_through_the_api():
    """``CEP.pattern(..., max_partials=n)`` reaches the operator the
    driver builds: a key with 12 live partials runs at 16 and overflows
    at the reference's 8."""
    def gen(split, i):
        if i >= 1:
            return None
        v = np.array([0] * 12 + [1])
        return ({"k": np.ones(13, np.int64), "v": v},
                np.arange(13, dtype=np.int64))

    def job(width):
        env = PORT.Env(PORT.Conf({"state.num-key-shards": 4,
                                  "state.slots-per-shard": 16}))
        sink = PORT.sinks.CollectSink()
        stream = (env.from_source(PORT.GeneratorSource(gen),
                                  PORT.WM.for_monotonous_timestamps())
                  .key_by("k"))
        C["port"].CEP.pattern(stream, ab(C["port"].Pattern, "NO_SKIP"),
                              max_partials=width).add_sink(sink)
        PORT.execute(env, "partials")
        return sink.rows

    assert len(job(16)) == 12
    with pytest.raises(RuntimeError, match="partial-buffer overflow"):
        job(8)
