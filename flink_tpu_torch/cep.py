"""CEP — complex event processing (pattern matching on keyed streams),
the JAX package's ``cep.py``: host numpy in both packages, no kernel.

ref: flink-libraries/flink-cep (Pattern.begin/next/followedBy/where/
within → NFACompiler → CepOperator keeping per-key NFA state +
partial-match buffers in keyed state).

Batch-first redesign: the reference walks one NFA per key per RECORD.
Here the per-key automaton state is COLUMNS over key slots (current
stage, window-start ts, per-stage match timestamps), and a microbatch
is processed by WITHIN-KEY RANK: sort by (key, ts), then step r
advances EVERY key's automaton on its r-th event of the batch at once —
the sequential dependence lives only along each key's own event chain,
so the loop length is the longest per-key run in the batch while each
step is one vectorized transition over all keys.

Supported semantics (a deterministic, documented subset of the
reference's full NFA):
- linear patterns: ``begin(a).next(b)`` (STRICT contiguity — the very
  next event of that key must match or the partial resets) and
  ``followed_by`` (RELAXED — non-matching events in between are
  skipped), with vectorized ``where`` predicates per stage;
- ``within(ms)``: a partial older than the window resets (the event
  that broke it may immediately start a new partial);
- negation (ref: Pattern.notNext / Pattern.notFollowedBy):
  ``not_next(name)`` — the key's immediately-next event must NOT match
  (a match kills the partial; any other event satisfies the constraint
  and is immediately re-tested against the following stage);
  ``not_followed_by(name)`` — NO matching event may occur strictly
  between the surrounding stages (an event matching both the forbidden
  predicate and the following stage counts as the following stage — no
  forbidden event occurred strictly between). A TRAILING
  not_followed_by turns ``within(ms)`` into an absence window: the
  match completes when the watermark (or a later in-stream event of
  the same key) passes ``match_start + within`` with no forbidden
  event seen; ``match_end`` is that deadline and the negated stage's
  ``<name>_ts`` column reads -1. Negated stages cannot be quantified,
  cannot begin a pattern, and run on the default single-partial engine
  only (the multi-partial after-match modes below refuse them);
- after-match skipping (ref: cep/nfa/aftermatch/AfterMatchSkipStrategy):
  SKIP_PAST_LAST_EVENT (default — each event belongs to at most one
  match, matches never overlap); ``after_match("NO_SKIP")`` —
  overlapping matches enumerated from a BOUNDED per-key partial buffer
  (``max_partials`` columns, loud overflow; linear patterns only —
  quantified patterns with NO_SKIP would need the reference's
  exponential SharedBuffer branch enumeration and are refused at
  build); ``after_match("SKIP_TO_FIRST", "b")`` /
  ``after_match("SKIP_TO_LAST", "b")`` — run on the same multi-partial
  engine, but each completed match prunes every partial (and any
  not-yet-emitted same-event completion) whose start precedes the
  first/last event the match mapped to stage ``b``;
- default mode keeps one active partial per key (greedy earliest): no
  simultaneous alternative partials. A failed strict transition
  re-tests the breaking event against stage 0.

Matches emit one row per completed pattern: key, ``<stage>_ts`` per
stage, and the match's start/end timestamps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.state.keyed import KeyDirectory, account_full_drop
from flink_tpu_torch.time.watermarks import LONG_MIN


@dataclasses.dataclass(frozen=True)
class _Stage:
    name: str
    where: Optional[Callable[[Dict[str, np.ndarray]], np.ndarray]]
    strict: bool  # True = next() contiguity; False = followed_by()
    times: int = 1        # expand into this many copies (times(n))
    loop: bool = False    # oneOrMore: greedy unbounded repetition
    optional: bool = False  # may be skipped when the NEXT stage matches
    negated: bool = False   # not_next / not_followed_by: a match KILLS


class Pattern:
    """Fluent pattern builder (ref: cep/pattern/Pattern.java)."""

    def __init__(self, stages: Tuple[_Stage, ...],
                 within_ms: Optional[int] = None,
                 after_match_mode: str = "SKIP_PAST_LAST_EVENT",
                 after_match_stage: Optional[str] = None):
        self._stages = stages
        self.within_ms = within_ms
        self.after_match_mode = after_match_mode
        self.after_match_stage = after_match_stage

    def _with(self, stages: Tuple[_Stage, ...]) -> "Pattern":
        return Pattern(stages, self.within_ms, self.after_match_mode,
                       self.after_match_stage)

    @classmethod
    def begin(cls, name: str) -> "Pattern":
        return cls((_Stage(name, None, strict=False),))

    def where(self, pred: Callable[[Dict[str, np.ndarray]], np.ndarray]) -> "Pattern":
        """Vectorized predicate over the batch's field arrays → (B,)
        bool. Applies to the most recent stage (for a negated stage it
        is the FORBIDDEN shape)."""
        last = self._stages[-1]
        return self._with(self._stages[:-1]
                          + (dataclasses.replace(last, where=pred),))

    def next(self, name: str) -> "Pattern":
        """STRICT contiguity: the key's immediately-next event."""
        return self._with(self._stages
                          + (_Stage(name, None, strict=True),))

    def followed_by(self, name: str) -> "Pattern":
        """RELAXED contiguity: later event, intervening ones skipped."""
        return self._with(self._stages
                          + (_Stage(name, None, strict=False),))

    # -- negation (ref: Pattern.notNext / Pattern.notFollowedBy) --------

    def not_next(self, name: str) -> "Pattern":
        """STRICT negation: the key's immediately-next event must NOT
        match this stage's where(). A match kills the partial (the
        killing event re-tests stage 0); any other event satisfies the
        constraint and is immediately re-tested against the following
        stage. Cannot end a pattern (there is no 'next event' deadline
        at the tail — use not_followed_by(...).within(ms))."""
        return self._with(self._stages
                          + (_Stage(name, None, strict=True,
                                    negated=True),))

    def not_followed_by(self, name: str) -> "Pattern":
        """RELAXED negation: NO event matching this stage's where()
        may occur strictly between the surrounding stages. An event
        matching both the forbidden predicate and the FOLLOWING stage
        counts as the following stage. As the LAST stage it needs
        ``within(ms)``: the absence window — the match completes when
        event time passes ``match_start + within`` with no forbidden
        event, ``match_end`` is that deadline, and the stage's
        ``<name>_ts`` column reads -1."""
        return self._with(self._stages
                          + (_Stage(name, None, strict=False,
                                    negated=True),))

    def within(self, ms: int) -> "Pattern":
        return Pattern(self._stages, int(ms), self.after_match_mode,
                       self.after_match_stage)

    def after_match(self, mode: str,
                    stage_name: Optional[str] = None) -> "Pattern":
        """After-match skip strategy (ref: cep/nfa/aftermatch/
        AfterMatchSkipStrategy): SKIP_PAST_LAST_EVENT (default —
        deterministic, each event in at most one match); NO_SKIP
        (the reference default — overlapping matches enumerated from a
        BOUNDED per-key partial buffer, cap + loud overflow; linear
        patterns only — quantifiers with NO_SKIP are refused at build
        because the branch enumeration is exactly the exponential
        SharedBuffer this design trades away); SKIP_TO_FIRST /
        SKIP_TO_LAST (``stage_name`` required) — same multi-partial
        engine, but each completed match prunes every partial whose
        start precedes the first/last event the match mapped to that
        stage (a ``times(n)`` stage resolves to its ``<name>_1`` /
        ``<name>_n`` expansion)."""
        modes = ("SKIP_PAST_LAST_EVENT", "NO_SKIP",
                 "SKIP_TO_FIRST", "SKIP_TO_LAST")
        if mode not in modes:
            raise ValueError(
                f"after_match mode {mode!r}: supported modes are "
                + ", ".join(modes))
        if mode in ("SKIP_TO_FIRST", "SKIP_TO_LAST"):
            if stage_name is None:
                raise ValueError(
                    f"after_match({mode!r}) needs the stage name the "
                    "skip anchors to: after_match(mode, 'stage')")
        elif stage_name is not None:
            raise ValueError(
                f"after_match({mode!r}) takes no stage name")
        return Pattern(self._stages, self.within_ms, mode, stage_name)

    # -- quantifiers (ref: cep/pattern/Quantifier.java) -----------------

    def times(self, n: int) -> "Pattern":
        """The most recent stage must occur exactly ``n`` times.
        Repetitions inherit the stage's contiguity (next → strict
        consecutive runs; followed_by → gaps allowed) and expand into
        ``n`` engine stages at build time, so the vectorized rank-step
        engine runs them unchanged. Match rows carry
        ``<name>_1_ts .. <name>_n_ts``."""
        if n < 1:
            raise ValueError(f"times({n}): n must be >= 1")
        last = self._stages[-1]
        if last.loop or last.optional:
            raise ValueError(
                f"stage {last.name!r} already has a quantifier")
        if last.negated:
            raise ValueError(
                f"negated stage {last.name!r} cannot be quantified")
        return self._with(self._stages[:-1]
                          + (dataclasses.replace(last, times=n),))

    def one_or_more(self) -> "Pattern":
        """GREEDY unbounded repetition of the most recent stage
        (ref: Pattern.oneOrMore, greedy + relaxed internal contiguity).
        Deterministic subset: the loop absorbs every matching event
        until an event matches the FOLLOWING stage (which terminates
        the match), so the pattern must continue past it — a trailing
        oneOrMore would need the reference's exponential partial-match
        buffers to decide when to emit. Match rows carry
        ``<name>_ts`` (first), ``<name>_last_ts`` and ``<name>_count``."""
        last = self._stages[-1]
        if last.strict:
            raise ValueError(
                "one_or_more() requires relaxed contiguity — use "
                "followed_by(), not next(), for the repeated stage")
        if last.times != 1 or last.optional:
            raise ValueError(
                f"stage {last.name!r} already has a quantifier")
        if last.negated:
            raise ValueError(
                f"negated stage {last.name!r} cannot be quantified")
        return self._with(self._stages[:-1]
                          + (dataclasses.replace(last, loop=True),))

    def optional(self) -> "Pattern":
        """The most recent stage may be absent: when an event matches
        the FOLLOWING stage while this one is pending, the automaton
        skips it (ref: Pattern.optional). Its ``<name>_ts`` column is
        -1 in matches where it was skipped."""
        last = self._stages[-1]
        if last.loop or last.times != 1:
            raise ValueError(
                f"stage {last.name!r} already has a quantifier")
        if last.negated:
            raise ValueError(
                f"negated stage {last.name!r} cannot be quantified")
        return self._with(self._stages[:-1]
                          + (dataclasses.replace(last, optional=True),))

    @property
    def stages(self) -> Tuple[_Stage, ...]:
        """Quantifier-EXPANDED engine stages + validation."""
        for s in self._stages:
            if s.where is None:
                raise ValueError(f"stage {s.name!r} has no where()")
        out: List[_Stage] = []
        for i, s in enumerate(self._stages):
            is_last = i == len(self._stages) - 1
            if s.loop and is_last:
                raise ValueError(
                    "a trailing one_or_more() cannot decide when the "
                    "match ends in the deterministic engine — add a "
                    "terminating stage after it")
            if s.optional and is_last:
                raise ValueError(
                    "a trailing optional() stage is not supported — "
                    "the match would be ambiguous (with-or-without)")
            if s.optional and i == 0:
                raise ValueError(
                    "optional() on the first stage is not supported — "
                    "the match start would be undefined when skipped")
            if s.negated and i == 0:
                raise ValueError(
                    "a pattern cannot begin with a negation — the "
                    "match start would be undefined (ref refuses "
                    "notFollowedBy as the first pattern too)")
            if s.negated and s.strict and is_last:
                raise ValueError(
                    "a trailing not_next() is not supported — there is "
                    "no 'next event' to wait for at the tail; use "
                    "not_followed_by(...) with within(ms) for an "
                    "absence window")
            if s.negated and not s.strict and is_last \
                    and self.within_ms is None:
                raise ValueError(
                    "a trailing not_followed_by() needs within(ms) — "
                    "the absence window that decides when 'it never "
                    "came' becomes a match")
            if s.negated and self._stages[i - 1].negated:
                raise ValueError(
                    "adjacent negated stages are not supported — merge "
                    "the forbidden predicates into one negated stage")
            if s.negated and (self._stages[i - 1].loop
                              or self._stages[i - 1].optional):
                raise ValueError(
                    f"negated stage {s.name!r} directly after a "
                    "quantified stage is not supported (the quantifier "
                    "exit would have to test the forbidden predicate)")
            if s.negated and not is_last and self._stages[i + 1].strict:
                raise ValueError(
                    f"stage after negated {s.name!r} must use "
                    "followed_by() (the negated stage consumes no "
                    "event, so strict next() contiguity is undefined)")
            if (s.loop or s.optional) and not is_last \
                    and self._stages[i + 1].strict:
                raise ValueError(
                    f"stage after quantified {s.name!r} must use "
                    "followed_by() (strict next() after a variable-"
                    "length stage is ambiguous)")
            if s.times == 1:
                out.append(s)
            else:
                for rep in range(1, s.times + 1):
                    out.append(dataclasses.replace(
                        s, name=f"{s.name}_{rep}", times=1,
                        # first repetition keeps the stage's contiguity
                        # vs its predecessor; the rest repeat with the
                        # stage's own contiguity between repetitions
                        strict=s.strict))
        if sum(1 for s in out if s.loop) > 1:
            raise ValueError(
                "at most one one_or_more() stage per pattern (the "
                "engine keeps a single loop counter per key)")
        return tuple(out)


class CepOperator:
    """Keyed pattern-matching operator (ref: cep/operator/CepOperator).
    Driver protocol mirrors KeyedProcessOperator: process_batch ingests,
    take_fired returns match rows."""

    def __init__(self, pattern: Pattern, *, num_shards: int = 128,
                 slots_per_shard: int = 1024, max_partials: int = 8) -> None:
        self.pattern = pattern
        self.stages = pattern.stages
        self.S = len(self.stages)
        if self.S < 1:
            raise ValueError("pattern needs at least one stage")
        self.directory = KeyDirectory(num_shards, slots_per_shard)
        cap = num_shards * slots_per_shard
        self.stage = np.zeros(cap, np.int32)        # next stage to match
        self.stage_ts = np.zeros((cap, self.S), np.int64)
        # quantifier flags over EXPANDED stages + loop state (at most
        # one one_or_more stage per pattern — validated at build)
        self._is_loop = np.array([s.loop for s in self.stages], bool)
        self._is_opt = np.array([s.optional for s in self.stages], bool)
        self._is_neg = np.array([s.negated for s in self.stages], bool)
        # trailing relaxed negation = absence pattern: a partial parked
        # at stage S-1 completes when event time passes
        # match_start + within with no forbidden event (build validated
        # within is set and the stage is relaxed)
        self._trail_neg = bool(self._is_neg[-1])
        self._loop_idx = (int(np.nonzero(self._is_loop)[0][0])
                          if self._is_loop.any() else -1)
        self.loop_cnt = np.zeros(cap, np.int32)
        self.loop_last = np.zeros(cap, np.int64)
        # highest event ts processed per key: the automaton consumes
        # each key's events in time order WITHIN a batch; an event
        # arriving in a later batch but timestamped before this frontier
        # cannot be sequenced (no cross-batch buffering in v1) — it is
        # dropped WITH accounting (late_records), never silently woven
        # in out of order (which could emit matches whose stage
        # timestamps run backward)
        self._last_ts = np.full(cap, np.iinfo(np.int64).min, np.int64)
        self.watermark = LONG_MIN
        self.late_records = 0
        self.records_dropped_full = 0
        self.state_version = 0
        self._matches: List[Dict[str, np.ndarray]] = []
        # NO_SKIP / SKIP_TO_FIRST / SKIP_TO_LAST: a BOUNDED
        # partial-match buffer per key — the SharedBuffer role (ref:
        # cep/nfa/sharedbuffer) capped at ``max_partials`` columns with
        # loud overflow. Linear patterns only: quantifiers would need
        # branch enumeration (the exponential part this design
        # refuses). ``no_skip`` names the ENGINE (multi-partial) — the
        # skip-to modes run on it with post-completion pruning.
        mode = pattern.after_match_mode
        self.no_skip = mode in ("NO_SKIP", "SKIP_TO_FIRST",
                                "SKIP_TO_LAST")
        # the partial buffer's width a key (the reference's fixed 8 by
        # default); its arrays are allocated only on that engine
        self.max_partials = int(max_partials)
        # SKIP_TO_FIRST/LAST anchor: index (in EXPANDED stages) of the
        # referenced stage — FIRST takes the earliest expansion
        # (<name>_1), LAST the latest (<name>_n)
        self._skip_ref: Optional[int] = None
        if mode in ("SKIP_TO_FIRST", "SKIP_TO_LAST"):
            ref_name = pattern.after_match_stage
            cands = [i for i, s in enumerate(self.stages)
                     if s.name == ref_name
                     or (s.name.rsplit("_", 1)[0] == ref_name
                         and s.name.rsplit("_", 1)[-1].isdigit())]
            if not cands:
                raise ValueError(
                    f"after_match({mode!r}, {ref_name!r}): no stage "
                    f"named {ref_name!r} (stages: "
                    f"{[s.name for s in self.stages]})")
            self._skip_ref = (cands[0] if mode == "SKIP_TO_FIRST"
                              else cands[-1])
        if self.no_skip:
            if self._is_loop.any() or self._is_opt.any():
                raise NotImplementedError(
                    f"after_match({mode!r}) supports linear patterns "
                    "(next/followed_by/times) only; one_or_more and "
                    "optional need the exponential branch enumeration "
                    "of the reference's SharedBuffer — use the default "
                    "SKIP_PAST_LAST_EVENT for quantified patterns")
            if self._is_neg.any():
                raise NotImplementedError(
                    f"after_match({mode!r}) does not support negated "
                    "stages — negation runs on the default "
                    "single-partial engine (SKIP_PAST_LAST_EVENT)")
            P = self.max_partials
            self.p_stage = np.full((cap, P), -1, np.int8)
            self.p_ts = np.zeros((cap, P, self.S), np.int64)

    # -- data plane ------------------------------------------------------

    def process_batch(self, keys, ts, data: Dict[str, np.ndarray],
                      valid=None) -> None:
        self.state_version += 1
        keys = np.asarray(keys, np.int64)
        ts = np.asarray(ts, np.int64)
        valid = (np.ones(len(ts), bool) if valid is None
                 else np.asarray(valid, bool))
        idx = np.nonzero(valid)[0]
        if len(idx) == 0:
            return
        slots = self.directory.assign(keys[idx])
        bad = slots < 0
        if bad.any():
            account_full_drop(self, int(bad.sum()))
            idx, slots = idx[~bad], slots[~bad]
        if len(idx) == 0:
            return

        # cross-batch order: drop events behind the key's frontier
        fresh = ts[idx] >= self._last_ts[slots]
        if not fresh.all():
            self.late_records += int((~fresh).sum())
            idx, slots = idx[fresh], slots[fresh]
            if len(idx) == 0:
                return

        # pre-evaluate every stage predicate over the whole batch ONCE
        # (vectorized; the rank loop below only gathers bits)
        sub = {k: np.asarray(v)[idx] for k, v in data.items()}
        preds = np.stack([np.asarray(st.where(sub), bool)
                          for st in self.stages])      # (S, n)

        # order by (key, ts); within-key rank = position in its run
        order = np.lexsort((ts[idx], keys[idx]))
        sl = slots[order].astype(np.int64)
        tt = ts[idx][order]
        kk = keys[idx][order]
        pr = preds[:, order]                            # (S, n)
        run_start = np.empty(len(sl), bool)
        run_start[0] = True
        run_start[1:] = kk[1:] != kk[:-1]
        rank = np.arange(len(sl)) - np.maximum.accumulate(
            np.where(run_start, np.arange(len(sl)), 0))
        max_rank = int(rank.max()) + 1
        # each rank's events as one slice of a stable sort by rank: the
        # positions ``rank == r`` selects, in the same order, without a
        # pass over the whole batch a step
        by_rank = np.argsort(rank, kind="stable")
        bounds = np.searchsorted(rank[by_rank], np.arange(max_rank + 1))
        steps = [by_rank[bounds[r]:bounds[r + 1]] for r in range(max_rank)]

        if self.no_skip:
            self._steps_no_skip(sl, tt, kk, pr, steps)
            return

        within = self.pattern.within_ms
        strict = np.array([s.strict for s in self.stages], bool)
        is_loop, is_opt, is_neg = self._is_loop, self._is_opt, self._is_neg
        for m in steps:                      # one event per key a step
            s_r = sl[m]
            t_r = tt[m]
            p_r = pr[:, m]                   # (S, k)
            k = len(s_r)
            ar = np.arange(k)
            cur = self.stage[s_r]            # (k,) next stage to match

            # trailing absence: a partial parked at the negated tail
            # whose deadline (match_start + within) the current event's
            # ts has passed COMPLETES — no forbidden event arrived in
            # the window (events arrive in ts order per key). Must run
            # BEFORE the expiry reset below, which tests the very same
            # age condition. The completing event then starts fresh
            # against stage 0 in this step.
            if self._trail_neg:
                due = ((cur == self.S - 1)
                       & (t_r - self.stage_ts[s_r, 0] > within))
                if due.any():
                    f = np.nonzero(due)[0]
                    self._matches.append(
                        self._absence_rows(s_r[f], kk[m][f]))
                    cur = np.where(due, 0, cur)

            # within-window expiry: partial too old resets to stage 0
            if within is not None:
                expired = (cur > 0) & (t_r - self.stage_ts[s_r, 0] > within)
                cur = np.where(expired, 0, cur)
                if self._loop_idx >= 0:
                    self.loop_cnt[s_r[expired]] = 0

            curc = np.minimum(cur, self.S - 1)
            hit_cur = p_r[curc, ar]
            nxtc = np.minimum(cur + 1, self.S - 1)
            has_next = cur + 1 < self.S
            hit_next = p_r[nxtc, ar] & has_next
            lp = is_loop[curc] & (cur < self.S)
            op_ = is_opt[curc] & (cur < self.S)
            ng = is_neg[curc] & (cur < self.S)
            ng_strict = ng & strict[curc]
            in_loop = lp & (self.loop_cnt[s_r] > 0)

            # decision precedence (greedy loop first):
            # A. loop enter/continue: stay, count, track first/last ts
            a_loop = lp & hit_cur
            # B. loop exit: the FOLLOWING stage's event terminates it
            b_exit = in_loop & ~hit_cur & hit_next
            # C. optional skip: next stage's event while optional pends
            c_skip = op_ & ~hit_cur & hit_next
            # N. negation: the forbidden event KILLS the partial.
            #    not_next: any hit on the immediately-next event kills;
            #    not_followed_by: a hit kills UNLESS the same event
            #    matches the FOLLOWING stage (then no forbidden event
            #    occurred strictly between — the event IS the next
            #    stage). A non-killing event at a negated stage either
            #    passes over it (hit_next → +2; not_next with no next
            #    hit → +1, the constraint is spent on this one event)
            #    or, for relaxed negation, is skipped (stay).
            n_kill = ng & hit_cur & (ng_strict | ~hit_next)
            n_pass2 = ng & ~n_kill & hit_next
            n_pass1 = ng_strict & ~n_kill & ~hit_next
            # D. plain advance
            d_adv = ~lp & ~c_skip & ~ng & hit_cur
            # E. strict miss -> partial dies (breaking event re-tests
            #    stage 0)
            miss_strict = (~a_loop & ~b_exit & ~c_skip & ~d_adv & ~ng
                           & ~hit_cur & strict[curc] & (cur > 0))
            die = miss_strict | n_kill
            restart = die & p_r[0, ar]

            new_stage = np.where(
                a_loop, cur,
                np.where(b_exit | c_skip | n_pass2, cur + 2,
                         np.where(d_adv | n_pass1, cur + 1,
                                  np.where(die,
                                           np.where(restart, 1, 0),
                                           cur))))

            # timestamp bookkeeping
            enter_loop = a_loop & ~in_loop
            if self._loop_idx >= 0:
                self.loop_cnt[s_r[enter_loop]] = 1
                cont = a_loop & in_loop
                self.loop_cnt[s_r[cont]] += 1
                self.loop_last[s_r[a_loop]] = t_r[a_loop]
            # first occurrence of a stage writes its ts: plain advances
            # at cur, loop entries at cur, exits/skips at cur+1
            w_cur = d_adv | enter_loop | restart
            st_cur = np.where(restart, 0, cur)
            self.stage_ts[s_r[w_cur], st_cur[w_cur]] = t_r[w_cur]
            w_nxt = b_exit | c_skip | n_pass2
            self.stage_ts[s_r[w_nxt], np.minimum(cur[w_nxt] + 1,
                                                 self.S - 1)] = t_r[w_nxt]
            # a skipped optional / passed negated stage reads -1 in the
            # match row (the stage consumed no event)
            w_abs = c_skip | n_pass2 | n_pass1
            self.stage_ts[s_r[w_abs], curc[w_abs]] = -1

            done = new_stage >= self.S
            if done.any():
                d = np.nonzero(done)[0]
                row = {"key": kk[m][d],
                       "match_start": self.stage_ts[s_r[d], 0].copy(),
                       "match_end": t_r[d].copy()}
                for si, stg in enumerate(self.stages):
                    row[f"{stg.name}_ts"] = self.stage_ts[s_r[d], si].copy()
                if self._loop_idx >= 0:
                    ln = self.stages[self._loop_idx].name
                    row[f"{ln}_last_ts"] = self.loop_last[s_r[d]].copy()
                    row[f"{ln}_count"] = self.loop_cnt[s_r[d]].copy()
                    self.loop_cnt[s_r[d]] = 0
                self._matches.append(row)
                new_stage = np.where(done, 0, new_stage)  # SKIP_PAST_LAST

            self.stage[s_r] = new_stage.astype(np.int32)
            self._last_ts[s_r] = t_r

    def _absence_rows(self, slots, keys) -> Dict[str, np.ndarray]:
        """Complete trailing-absence partials: the window
        [match_start, match_start + within] closed with no forbidden
        event. Builds the match rows (match_end = the deadline; the
        negated tail's ts column = -1) and resets the partials."""
        within = self.pattern.within_ms
        start = self.stage_ts[slots, 0].copy()
        row = {"key": np.asarray(keys, np.int64).copy(),
               "match_start": start,
               "match_end": start + within}
        for si, stg in enumerate(self.stages):
            row[f"{stg.name}_ts"] = (
                np.full(len(slots), -1, np.int64) if stg.negated
                else self.stage_ts[slots, si].copy())
        if self._loop_idx >= 0:
            ln = self.stages[self._loop_idx].name
            row[f"{ln}_last_ts"] = self.loop_last[slots].copy()
            row[f"{ln}_count"] = self.loop_cnt[slots].copy()
            self.loop_cnt[slots] = 0
        self.stage[slots] = 0
        return row

    def _steps_no_skip(self, sl, tt, kk, pr, steps) -> None:
        """NO_SKIP rank-step engine: every key advances ALL its live
        partials on each event at once (vectorized over keys × the
        bounded partial axis), and an event matching stage 0 also
        SPAWNS a fresh partial — overlapping matches enumerate across
        partials. Per partial the take is greedy (the operator's
        documented determinism trade); across partials the overlap
        semantics match the reference's NO_SKIP for linear patterns.

        BATCH ATOMICITY: the partial-buffer overflow error must leave
        the operator exactly as it was before the batch — earlier rank
        steps have already advanced partials and appended matches by the
        time a later rank overflows, and a caller that catches the error
        (to fail over through restore, or to drop the batch) must not
        observe half-applied state or double-emitted matches on retry.
        The touched rows (only the batch's key slots) are snapshotted on
        entry and rolled back on the error path — an exact guarantee a
        pre-scan cannot give, since slot liberation (expiry, completion,
        strict death) during the batch feeds back into overflow. One
        deliberate residue: key-directory slots assigned for the batch's
        new keys (in process_batch, before this point) stay assigned —
        the key→slot mapping is idempotent and carries no match state,
        the slot is reused if the key returns, and a restore-from-
        checkpoint rebuilds the directory anyway; only keys never seen
        again leave an empty slot behind."""
        touched = np.unique(sl)
        bak = (self.p_stage[touched].copy(), self.p_ts[touched].copy(),
               self._last_ts[touched].copy(), len(self._matches))
        try:
            self._steps_no_skip_inner(sl, tt, kk, pr, steps)
        except Exception:
            self.p_stage[touched], self.p_ts[touched] = bak[0], bak[1]
            self._last_ts[touched] = bak[2]
            del self._matches[bak[3]:]
            raise

    def _steps_no_skip_inner(self, sl, tt, kk, pr, steps) -> None:
        S, P = self.S, self.max_partials
        within = self.pattern.within_ms
        strict = np.array([s.strict for s in self.stages], bool)
        for m in steps:
            s_r = sl[m]
            t_r = tt[m]
            p_r = pr[:, m]                     # (S, k)
            k = len(s_r)
            ar = np.arange(k)
            st = self.p_stage[s_r].astype(np.int32)   # (k, P)
            act = st >= 0
            if within is not None and act.any():
                exp = act & (t_r[:, None] - self.p_ts[s_r, :, 0] > within)
                st = np.where(exp, -1, st)
                act = st >= 0
            stc = np.clip(st, 0, S - 1)
            hit = p_r.T[ar[:, None], stc] & act       # (k, P)
            died = act & ~hit & strict[stc] & (st > 0)
            adv = act & hit
            ii, pp = np.nonzero(adv)
            if len(ii):
                self.p_ts[s_r[ii], pp, stc[ii, pp]] = t_r[ii]
            st = np.where(adv, st + 1, np.where(died, -1, st))
            compl = st >= S
            if compl.any():
                ci, cp = np.nonzero(compl)
                if self._skip_ref is None:
                    # NO_SKIP: every completion emits
                    row = {"key": kk[m][ci],
                           "match_start": self.p_ts[s_r[ci], cp, 0].copy(),
                           "match_end": t_r[ci].copy()}
                    for si, stg in enumerate(self.stages):
                        row[f"{stg.name}_ts"] = self.p_ts[
                            s_r[ci], cp, si].copy()
                    self._matches.append(row)
                else:
                    # SKIP_TO_FIRST/LAST: per key, completions resolve
                    # in ascending match_start; each emitted match
                    # prunes every partial — and every not-yet-emitted
                    # completion — whose start precedes the ts of the
                    # event it mapped to the referenced stage.
                    # Completions are rare; this stays scalar.
                    ref = self._skip_ref
                    for i in np.unique(ci):
                        pps = cp[ci == i]
                        starts = self.p_ts[s_r[i], pps, 0]
                        cut = None
                        for p in pps[np.argsort(starts, kind="stable")]:
                            if cut is not None \
                                    and self.p_ts[s_r[i], p, 0] < cut:
                                continue  # pruned by an earlier match
                            row = {
                                "key": kk[m][[i]].copy(),
                                "match_start": self.p_ts[
                                    s_r[i], p, [0]].copy(),
                                "match_end": t_r[[i]].copy()}
                            for si, stg in enumerate(self.stages):
                                row[f"{stg.name}_ts"] = self.p_ts[
                                    s_r[i], p, [si]].copy()
                            self._matches.append(row)
                            cut = int(self.p_ts[s_r[i], p, ref])
                        live = (st[i] >= 0) & (st[i] < S)
                        st[i, live
                           & (self.p_ts[s_r[i], :, 0] < cut)] = -1
                st = np.where(compl, -1, st)
            # spawn: stage-0 match starts a NEW partial (even when the
            # same event extended others — the overlap contract)
            want = p_r[0]
            if want.any():
                free = st < 0
                has_free = free.any(axis=1)
                over = want & ~has_free
                if over.any():
                    raise RuntimeError(
                        f"CEP NO_SKIP partial-buffer overflow: a key "
                        f"exceeded {P} simultaneous partial matches "
                        "(cep max_partials); narrow the begin-stage "
                        "predicate, add within(), or use "
                        "SKIP_PAST_LAST_EVENT")
                ff = np.argmax(free, axis=1)
                wi = np.nonzero(want)[0]
                if S == 1:
                    self._matches.append({
                        "key": kk[m][wi],
                        "match_start": t_r[wi].copy(),
                        "match_end": t_r[wi].copy(),
                        f"{self.stages[0].name}_ts": t_r[wi].copy()})
                else:
                    st[wi, ff[wi]] = 1
                    self.p_ts[s_r[wi], ff[wi], 0] = t_r[wi]
            self.p_stage[s_r] = st.astype(np.int8)
            self._last_ts[s_r] = t_r

    def take_fired(self):
        from flink_tpu_torch.ops.window import FiredWindows

        if not self._matches:
            return None
        parts = self._matches
        self._matches = []
        out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        out["__ts__"] = out["match_end"].astype(np.int64)
        return FiredWindows(data=out)

    # -- time plane ------------------------------------------------------

    def advance_watermark(self, wm: int):
        from flink_tpu_torch.ops.window import FiredWindows

        if wm > self.watermark:
            self.watermark = wm
        # trailing absence: the watermark passing a pending partial's
        # deadline PROVES no forbidden event with ts <= deadline is
        # still coming — the match completes on time progress alone
        # (the in-stream path in process_batch only helps keys that
        # keep receiving events)
        if self._trail_neg and self.watermark != LONG_MIN:
            within = self.pattern.within_ms
            pend = self.stage == self.S - 1
            due = pend & (self.stage_ts[:, 0] + within <= self.watermark)
            if due.any():
                self.state_version += 1
                slots = np.nonzero(due)[0]
                keys = self.directory.key_of_slots(slots)
                row = self._absence_rows(slots, keys)
                row["__ts__"] = row["match_end"].astype(np.int64).copy()
                return FiredWindows(data=row)
        return FiredWindows(data={"__ts__": np.zeros(0, np.int64)})

    def final_watermark(self) -> int:
        base = self.watermark if self.watermark != LONG_MIN else 0
        if self._trail_neg:
            # flush every pending absence window at end of input
            pend = self.stage == self.S - 1
            if pend.any():
                base = max(base, int(self.stage_ts[pend, 0].max())
                           + self.pattern.within_ms)
        return base

    def quiesce(self) -> None:
        pass

    def throttle(self) -> None:
        pass

    # -- snapshot seam ----------------------------------------------------

    def snapshot_state(self) -> Dict[str, Any]:
        return {
            "kind": "cep",
            "directory": self.directory.snapshot(),
            "stage": self.stage.copy(),
            "stage_ts": self.stage_ts.copy(),
            "loop_cnt": self.loop_cnt.copy(),
            "loop_last": self.loop_last.copy(),
            "watermark": self.watermark,
            "late_records": self.late_records,
            "records_dropped_full": self.records_dropped_full,
            "last_ts": self._last_ts.copy(),
            "p_stage": (self.p_stage.copy() if self.no_skip else None),
            "p_ts": (self.p_ts.copy() if self.no_skip else None),
        }

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if self.no_skip and snap.get("p_stage") is not None:
            width = np.shape(snap["p_stage"])[1]
            if width != self.max_partials:
                raise ValueError(
                    f"snapshot's partial buffer is {width} wide; this "
                    f"operator's max_partials is {self.max_partials}")
        self.directory = KeyDirectory.restore(
            self.directory.num_shards, self.directory.slots_per_shard,
            snap["directory"],
            (self.directory.shard_lo, self.directory.shard_hi))
        self.stage = np.array(snap["stage"])
        self.stage_ts = np.array(snap["stage_ts"])
        if snap.get("loop_cnt") is not None:
            self.loop_cnt = np.array(snap["loop_cnt"])
            self.loop_last = np.array(snap["loop_last"])
        self.watermark = snap["watermark"]
        self.late_records = snap["late_records"]
        self.records_dropped_full = snap["records_dropped_full"]
        self._last_ts = np.array(snap["last_ts"])
        if self.no_skip and snap.get("p_stage") is not None:
            self.p_stage = np.array(snap["p_stage"])
            self.p_ts = np.array(snap["p_ts"])
        self._matches = []


class CEP:
    """Entry point (ref: cep/CEP.java): ``CEP.pattern(keyed_stream,
    pattern)`` → DataStream of match rows."""

    @staticmethod
    def pattern(keyed_stream, pattern: Pattern, name: str = "cep",
                max_partials: int = 8):
        """``max_partials``: the multi-partial engine's buffer width a
        key (NO_SKIP, SKIP_TO_*), 8 as in the reference by default."""
        from flink_tpu_torch.graph.transformations import CepTransformation

        kt = keyed_stream.transform
        t = CepTransformation(name, (kt,), pattern=pattern,
                              key_field=kt.key_field,
                              max_partials=max_partials)
        keyed_stream.env._register(t)
        from flink_tpu_torch.api.datastream import DataStream

        return DataStream(keyed_stream.env, t)
