#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``flink_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (or
another sm_90a card), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``build``   — compiles ``flink_tpu_torch/kernels/csrc/*.cu`` with nvcc
   (one process per source, started together) into
   ``flink_tpu_torch/_build/``.
2. ``kernels`` — each kernel against its plain PyTorch version on the
   card, exactly (all are integer work), then its time (CUDA events,
   warmed, many launches), the plain version's time, the time of one
   PyTorch library call computing the same function where there is
   one, and the least time the card could take (bytes over 3.35 TB/s
   or operations over 67 T/s, whichever is larger). The four window
   kernels at the host-fed Q5 shapes (128 x 256 key slots + 1 dump row,
   a 32-column pane ring, 11 windows of 10 panes, ~110k host-combined
   pairs); ``nexmark_bids`` and ``devgen_ingest`` at the headline shapes
   (a 2^20-bid sub-batch, 32,769 x 64 state, 10,000 auctions, hot ratio
   4), plus a ``devgen_ingest`` case with out-of-domain and late
   records that compares the stats vector and re-fire bitmap too.
3. ``q5``      — Nexmark Q5 hot items, host-fed, through the port's
   ``StreamExecutionEnvironment.execute()`` at the conf of
   ``confs/bench_q5_host_fed.conf`` on 16 batches of 2^20 bids.
4. ``q5_devgen`` — the headline path: Q5 with bids made on the card, at
   ``confs/bench_q5_headline.conf`` (2^22-bid logical batches in 4
   sub-batches, 128 x 256 key slots) on 16 logical batches (67,108,864
   bids): one short warm-up run, then five timed runs, each checked in
   full; the median run's numbers are printed beside every run's rate.
   Then 4 logical batches at 1 and at 4 sub-batches (the first with a
   64-column pane ring), whose rows must agree window by window.

In the two Q5 phases every kernel's launch counter is zeroed just
before the run and read just after; each kernel of the path must have
launched, the committed rows must equal a numpy golden of
per-(auction, window) counts and each window's max set, and the phase
prints events/s and the device's idle share (CUDA events around each
launch group).

Then the card's name and power limit (nvidia-smi), the kernel table as
one JSON object, and last ``{"ok": true, "device": {...}}``. Any
failure exits non-zero without that last line; so does a machine with
no CUDA device, and a directory without the package.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT_OPS_PER_S = 67e12          # non-tensor-core rate (fp32 table entry)
Q5_BATCH = 1 << 20
Q5_BATCHES = 16
DEVGEN_BATCH = 1 << 22          # confs/bench_q5_headline.conf
DEVGEN_BATCHES = 16
DEVGEN_SUB = 4
DEVGEN_K_BATCHES = 4            # the K = 1 / K = 4 comparison
DEVGEN_RUNS = 5                 # timed headline runs, after one warm-up
SEED = 20261017
KERNEL_SOURCES = ("window_kernels", "devgen_kernels")
# wrapper -> its CUDA kernels' names, to read the profiler's table
PROFILED_KERNELS = {
    "window_counts": ("window_counts_kernel",),
    "topn_select_append": ("topn_threshold_kernel", "topn_count_kernel",
                           "topn_write_kernel"),
    "ring_columns": ("ring_columns_kernel",),
    "nexmark_bids": ("nexmark_bids_kernel",),
    "devgen_ingest": ("devgen_ingest_kernel",),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from flink_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(KERNEL_SOURCES)
    out = {"phase": "build", "seconds": time.perf_counter() - t0}
    for name in KERNEL_SOURCES:
        log = build.BUILD_LOG[name]
        out[name] = {
            "cmd": " ".join(log["cmd"] or []), "cached": log["cached"],
            "seconds": log["seconds"],
            "ptxas": [ln.strip() for ln in log["ptxas"].splitlines()
                      if "registers" in ln or "spill" in ln]}
    emit(out)


def phase_kernels(torch, np):
    """Each kernel against its plain version at the Q5 shapes."""
    from flink_tpu_torch.kernels import window_kernels as wk

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    slots, ring, ppw, W, n_keys = 128 * 256, 32, 10, 11, 10_000
    rows = slots + 1
    pane_lo, pane_hi = 1000, 1020            # 21 live panes of the 32
    used_np = np.zeros(rows, bool)
    key_rows = rng.choice(slots, n_keys, replace=False)
    used_np[key_rows] = True
    counts_np = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, pane_hi + 1):
        counts_np[key_rows, p % ring] = rng.poisson(9.5, n_keys)
    counts_np[key_rows[:100], :] *= 26       # the hot auctions
    # one batch's host-combined pairs: every key x 11 panes
    batch_panes = np.arange(pane_hi - 10, pane_hi + 1)
    pairs = (key_rows[:, None] * ring + batch_panes[None, :] % ring).reshape(-1)
    idx_np = rng.permutation(pairs).astype(np.int32)
    cnt_np = (rng.poisson(9.5, len(idx_np)) + 1).astype(np.int32)

    counts = torch.from_numpy(counts_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    cnt = torch.from_numpy(cnt_np).to(dev)
    used = torch.from_numpy(used_np).to(dev)
    ends = torch.arange(pane_hi - W + 2, pane_hi + 2, dtype=torch.int64, device=dev)
    w_valid = torch.ones(W, dtype=torch.bool, device=dev)
    emit_ring = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    n_top, sel_cap, anchor = 1, 256, pane_lo
    out = []

    def record(name, replaces, err, ms, plain, lib, nbytes, nops,
               source="window_kernels.cu"):
        b, by = bound_ms(nbytes, nops)
        out.append({"name": name, "route": "cuda",
                    "source": "flink_tpu_torch/kernels/csrc/" + source,
                    "replaces": replaces, "launches": None,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": b, "bound_by": by, "library_ms": lib})

    def max_err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    # K1: scatter_counts
    a, b = counts.clone(), counts.clone()
    wk.scatter_counts(a, idx, cnt)
    wk.scatter_counts_plain(b, idx, cnt)
    torch.cuda.synchronize()
    err = max_err(a, b)
    check(err == 0, f"scatter_counts differs from its plain version by {err}")
    idx_long = idx.long()
    scratch = counts.clone()
    n = idx.numel()
    record("scatter_counts", "flink_tpu/ops/window.py:190", err,
           time_ms(torch, lambda: wk.scatter_counts(scratch, idx, cnt)),
           time_ms(torch, lambda: wk.scatter_counts_plain(scratch, idx, cnt)),
           time_ms(torch, lambda: scratch.view(-1).index_add_(0, idx_long, cnt)),
           16 * n, n)

    # K2: window_counts
    wc = wk.window_counts(a, ends, w_valid, pane_lo, pane_hi, ppw)
    wc_plain = wk.window_counts_plain(a, ends, w_valid, pane_lo, pane_hi, ppw)
    torch.cuda.synchronize()
    err = max_err(wc, wc_plain)
    check(err == 0, f"window_counts differs from its plain version by {err}")
    # the bound reads only the ring columns some window sums: the union
    # of the windows' live panes, each column once per row
    hi_cap = min(pane_hi, pane_lo + ring - 1)
    spans = [range(max(e - ppw, pane_lo), min(e - 1, hi_cap) + 1)
             for e, ok in zip(ends.tolist(), w_valid.tolist()) if ok]
    live = sum(len(sp) for sp in spans)
    live_cols = len({p % ring for sp in spans for p in sp})
    record("window_counts", "flink_tpu/ops/window.py:286", err,
           time_ms(torch, lambda: wk.window_counts(a, ends, w_valid, pane_lo,
                                                   pane_hi, ppw)),
           time_ms(torch, lambda: wk.window_counts_plain(a, ends, w_valid,
                                                         pane_lo, pane_hi, ppw)),
           None, rows * live_cols * 4 + rows * W * 4 + W * 9, rows * live)

    # K3: topn_select_append
    r1, r2 = emit_ring.clone(), emit_ring.clone()
    wk.topn_select_append(wc, used, ends, w_valid, anchor, n_top, sel_cap, r1)
    wk.topn_select_append_plain(wc, used, ends, w_valid, anchor, n_top,
                                sel_cap, r2)
    torch.cuda.synchronize()
    err = max_err(r1[:-1], r2[:-1])
    check(err == 0, f"topn_select_append differs from its plain version by {err}")
    written = int(r1[0, 0])
    check(written >= W and int(r1[0, 1]) == 0, f"ring head {r1[0].tolist()}")
    r3, r4 = emit_ring.clone(), emit_ring.clone()
    record("topn_select_append", "flink_tpu/ops/window.py:547", err,
           time_ms(torch, lambda: wk.topn_select_append(
               wc, used, ends, w_valid, anchor, n_top, sel_cap, r3)),
           time_ms(torch, lambda: wk.topn_select_append_plain(
               wc, used, ends, w_valid, anchor, n_top, sel_cap, r4)),
           None, rows * W * 4 + rows + W * 9 + written * 12 + 8,
           rows * W * (2 * n_top + 2))

    # K4: ring_columns — the per-advance purge (11 dead columns), and a
    # ring growth 16 -> 32 checked for equality
    keep_np = np.ones(ring, bool)
    keep_np[np.arange(pane_lo - 11, pane_lo) % ring] = False
    keep = torch.from_numpy(keep_np).to(dev)
    ident = torch.arange(ring, dtype=torch.int32, device=dev)
    x, y = a.clone(), a.clone()
    wk.ring_columns(x, x, ident, keep)
    wk.ring_columns_plain(y, y, ident, keep)
    small = a[:, :16].contiguous()
    cmap = np.full(32, -1, np.int64)
    ps = np.arange(1003, 1003 + 14)
    cmap[ps % 32] = ps % 16
    src_col = torch.from_numpy(np.maximum(cmap, 0).astype(np.int32)).to(dev)
    keep_g = torch.from_numpy(cmap >= 0).to(dev)
    g1 = torch.empty((rows, 32), dtype=torch.int32, device=dev)
    g2 = torch.empty_like(g1)
    wk.ring_columns(small, g1, src_col, keep_g)
    wk.ring_columns_plain(small, g2, src_col, keep_g)
    torch.cuda.synchronize()
    err = max(max_err(x, y), max_err(g1, g2))
    check(err == 0, f"ring_columns differs from its plain version by {err}")
    cleared = torch.from_numpy(np.flatnonzero(~keep_np)).to(dev)
    n_cleared = int((~keep_np).sum())
    record("ring_columns", "flink_tpu/ops/window.py:825", err,
           time_ms(torch, lambda: wk.ring_columns(x, x, ident, keep)),
           time_ms(torch, lambda: wk.ring_columns_plain(y, y, ident, keep)),
           time_ms(torch, lambda: y.index_fill_(1, cleared, 0)),
           rows * n_cleared * 4 + ring * 5, 0)
    wk.check_errors(dev)
    extra = devgen_kernel_cases(torch, np, dev, record)
    wk.check_errors(dev)
    emit({"phase": "kernels", **extra, "kernels": [
        {k: v for k, v in r.items() if k != "launches"} for r in out]})
    return out


def devgen_kernel_cases(torch, np, dev, record):
    """K5 and K6 at the headline shapes: sub-batch 1 of logical batch 5
    (2^20 bids of a 2^22 batch, 100 bids/ms, 10,000 auctions, hot ratio
    4) into 32,769 x 64 state."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    n, total, epm, hot_ratio, n_auctions = 1 << 20, 1 << 22, 100, 4, 10_000
    n_hot = n_auctions // 100
    rows, ring, key_domain = 128 * 256 + 1, 64, n_auctions
    args = (5, n, n, total, epm, hot_ratio, n_hot, n_auctions)

    # K5: nexmark_bids
    keys, ts = dk.nexmark_bids(*args, dev)
    pk, pt = dk.nexmark_bids_plain(*args, dev)
    torch.cuda.synchronize()
    err = max(int((keys - pk).abs().max()), int((ts - pt).abs().max()))
    check(err == 0, f"nexmark_bids differs from its plain version by {err}")
    record("nexmark_bids", "flink_tpu/nexmark/generator.py:125", err,
           time_ms(torch, lambda: dk.nexmark_bids(*args, dev)),
           time_ms(torch, lambda: dk.nexmark_bids_plain(*args, dev)),
           None, 16 * n, 22 * n, source="devgen_kernels.cu")

    # K6: devgen_ingest, steady state (every key in the domain, nothing
    # late, no re-fire) with and without the stats vector (the headline
    # path runs without), then a case with out-of-domain and late records
    pane_lo = int(ts.min()) // 1000
    kw = dict(key_domain=key_domain, pane_ms=1000, offset_ms=0,
              dead_below=pane_lo - 1, refire_below=-(2 ** 63),
              dump_row=rows - 1)

    def ingest_pair(k, t, kw, with_stats=True):
        a = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
        b = a.clone()
        sa = dk.devgen_ingest(a, k, t, with_stats=with_stats, **kw)
        sb = dk.devgen_ingest_plain(b, k, t, kw["key_domain"], kw["pane_ms"],
                                    kw["offset_ms"], kw["dead_below"],
                                    kw["refire_below"], kw["dump_row"],
                                    torch.zeros_like(sa) if with_stats
                                    else None)
        torch.cuda.synchronize()
        err = int((a - b).abs().max())
        if with_stats:
            err = max(err, int((sa - sb).abs().max()))
        return err, a, sa

    err, state, stats = ingest_pair(keys, ts, kw)
    check(err == 0, f"devgen_ingest differs from its plain version by {err}")
    check(int(stats[0]) == n and int(state.sum()) == n,
          f"devgen_ingest stats {stats[:8].tolist()}")
    err0, state0, _ = ingest_pair(keys, ts, kw, with_stats=False)
    check(err0 == 0 and torch.equal(state0, state),
          f"devgen_ingest without stats differs by {err0}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    odd = keys.clone()
    pick = torch.rand(n, generator=gen, device=dev)
    odd[pick < 0.03] += key_domain             # out of the domain
    odd[pick > 0.99] = -7                      # negative keys
    kw_late = dict(kw, dead_below=pane_lo + 3, refire_below=pane_lo + 6)
    err2, _, stats2 = ingest_pair(odd, ts, kw_late)
    check(err2 == 0, "devgen_ingest (out-of-domain and late records) "
          f"differs from its plain version by {err2}")
    head = stats2[:8].tolist()
    check(head[1] > 0 and head[2] > 0 and head[4] > 0
          and int(stats2[8:].sum()) > 0, f"edge case stats {head}")
    # the cells the steady batch adds into (every record valid here)
    flat = torch.where(keys < key_domain, keys * ring + torch.remainder(
        torch.div(ts, 1000, rounding_mode="floor"), ring), kw["dump_row"] * ring)
    n_cells = int(torch.unique(flat).numel())
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    scratch = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
    plain_scratch = scratch.clone()
    # timed in the headline path's form, without the stats vector. The
    # bound reads each record's key and ts once and reads and writes each
    # distinct cell once (the ~1e5 cells' atomics meet in L2, where the
    # whole 8.4 MB state fits)
    record("devgen_ingest", "flink_tpu/ops/window.py:712",
           max(err, err0, err2),
           time_ms(torch, lambda: dk.devgen_ingest(scratch, keys, ts,
                                                   with_stats=False, **kw)),
           time_ms(torch, lambda: dk.devgen_ingest_plain(
               plain_scratch, keys, ts, kw["key_domain"], kw["pane_ms"],
               kw["offset_ms"], kw["dead_below"], kw["refire_below"],
               kw["dump_row"], None)),
           time_ms(torch, lambda: scratch.view(-1).index_add_(0, flat, ones)),
           16 * n + 8 * n_cells, 15 * n, source="devgen_kernels.cu")
    return {"devgen_ingest_distinct_cells": n_cells}


def q5_golden(np, parts, n_auctions: int, window_panes: int, pane_ms: int):
    """(auction, window_end, count) rows: every window's max-count
    auctions, from per-(auction, pane) counts summed over the window.
    ``parts`` yields (auction, ts) arrays."""
    parts_a, parts_p = [], []
    for a, ts in parts:
        parts_a.append(a)
        parts_p.append(ts // pane_ms)
    auction = np.concatenate(parts_a)
    pane = np.concatenate(parts_p)
    n_a, n_p = n_auctions, int(pane.max()) + 1
    per_pane = np.bincount(auction * n_p + pane,
                           minlength=n_a * n_p).reshape(n_a, n_p)
    cs = np.concatenate([np.zeros((n_a, 1), np.int64),
                         np.cumsum(per_pane, axis=1)], axis=1)
    expect = set()
    for e in range(1, n_p + window_panes):
        win = cs[:, min(e, n_p)] - cs[:, max(e - window_panes, 0)]
        best = int(win.max())
        if best > 0:
            for a in np.flatnonzero(win == best):
                expect.add((int(a), e * pane_ms, best))
    return expect


def phase_q5(torch, np):
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream
    from flink_tpu_torch.nexmark.queries import q5_hot_items

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))
    cfg = NexmarkConfig(batch_size=Q5_BATCH, n_batches=Q5_BATCHES,
                        events_per_ms=100, num_active_auctions=10_000,
                        hot_ratio=4)
    parts = []
    env = StreamExecutionEnvironment(conf)
    q5_hot_items(env, bid_stream(cfg), FnSink(
        lambda b: parts.append({k: np.asarray(v).copy() for k, v in b.items()})),
        window_ms=10_000, slide_ms=1_000, out_of_orderness_ms=1_000)
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute("nexmark-q5-host-fed", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(wk.LAUNCHES)
    on_path = ("scatter_counts", "window_counts", "topn_select_append",
               "ring_columns")
    missing = [k for k in on_path if launches[k] == 0]
    check(not missing, f"kernels not launched on the host-fed path: {missing}")
    rows = [(int(a), int(w), int(c)) for p in parts
            for a, w, c in zip(p["auction"], p["window_end"], p["bid_count"])]
    from flink_tpu_torch.nexmark.generator import bid_batch

    expect = q5_golden(
        np, ((d["auction"], t) for d, t in
             (bid_batch(cfg, 0, i) for i in range(cfg.n_batches))),
        cfg.num_active_auctions, window_panes=10, pane_ms=1000)
    check(len(rows) == len(set(rows)), "duplicate committed rows")
    got = set(rows)
    check(got == expect,
          f"Q5 rows differ from the golden: {len(got - expect)} extra, "
          f"{len(expect - got)} missing of {len(expect)}")
    busy = {k.split(".")[-1]: v for k, v in res.metrics.items()
            if k.startswith("device_busy_ms.")}
    events = Q5_BATCH * Q5_BATCHES
    host = {k.split(".", 2)[-1]: v for k, v in res.metrics.items()
            if k.startswith("profile.")}
    emit({"phase": "q5", "events": events, "batches": Q5_BATCHES,
          "wall_s": wall, "events_per_s": events / wall,
          "rows": len(rows), "windows": len({w for _, w, _ in rows}),
          "launches": launches, "device_busy_ms": busy,
          "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
          "host_profile_s": host})
    return launches


def run_devgen_q5(torch, np, conf, cfg, label):
    """Q5 on bids made on the card through ``env.execute()``: (rows in
    commit order, launches, JobResult, wall seconds)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import bid_stream_device
    from flink_tpu_torch.nexmark.queries import q5_hot_items

    parts = []
    env = StreamExecutionEnvironment(conf)
    q5_hot_items(env, bid_stream_device(cfg), FnSink(
        lambda b: parts.append({k: np.asarray(v).copy() for k, v in b.items()})),
        window_ms=10_000, slide_ms=1_000, out_of_orderness_ms=1_000)
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(wk.LAUNCHES)
    rows = [(int(a), int(w), int(c)) for p in parts
            for a, w, c in zip(p["auction"], p["window_end"], p["bid_count"])]
    return rows, launches, res, wall


def profile_devgen(torch, np, conf_path, cfg):
    """Kernel time by name from ``torch.profiler`` over a devgen Q5 run
    of ``cfg`` at the headline conf: the device's busy share without the
    launch gaps that CUDA event spans count as busy. The profiler slows
    the host, so this run's wall (and idle share) is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.config import Configuration

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = run_devgen_q5(
            torch, np, Configuration.from_file(conf_path), cfg,
            "q5-devgen-profiled")
    # device-side entries only (kernels, memcpy, memset): a host op such
    # as aten::copy_ also carries its kernels' time, which would count
    # twice
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = {"device_ms": us / 1e3, "count": e.count}
    busy_ms = sum(v["device_ms"] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms"])[:12]
    # device ms per wrapper call: its CUDA kernels' total over the calls
    # (topn_select_append launches three kernels per call)
    per_call = {}
    for name, kernels in PROFILED_KERNELS.items():
        hits = [v for k, v in by_name.items()
                if any(f"::{kn}(" in k for kn in kernels)]
        if hits:
            calls = max(v["count"] for v in hits)
            per_call[name] = sum(v["device_ms"] for v in hits) / calls
    return {"logical_batches": cfg.n_batches, "wall_s": wall,
            "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / (wall * 1e3)
                                  if busy_ms > 0 else "not measured"),
            "device_ms_per_call": per_call, "top_device_ms": dict(top)}


def phase_q5_devgen(torch, np):
    from flink_tpu_torch.config import Configuration, PipelineOptions
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream_device

    path = os.path.join(ROOT, "confs", "bench_q5_headline.conf")
    conf = Configuration.from_file(path)
    check(int(conf.get(PipelineOptions.MICROBATCH_SIZE)) == DEVGEN_BATCH
          and int(conf.get(PipelineOptions.SUB_BATCHES)) == DEVGEN_SUB,
          "confs/bench_q5_headline.conf is not the headline shape")
    cfg = NexmarkConfig(batch_size=DEVGEN_BATCH, n_batches=DEVGEN_BATCHES,
                        events_per_ms=100, num_active_auctions=10_000,
                        hot_ratio=4)

    def golden(n_logical):
        src = bid_stream_device(cfg)
        return q5_golden(np, (src.keys_ts_host(i) for i in range(n_logical)),
                         cfg.num_active_auctions, window_panes=10,
                         pane_ms=1000)

    # one short warm-up run at the same shapes (first-use allocations:
    # pinned buffers, the emit ring, the caching allocator's blocks),
    # then DEVGEN_RUNS timed runs, each checked in full
    run_devgen_q5(torch, np, conf,
                  dataclasses.replace(cfg, n_batches=2), "q5-devgen-warmup")
    n_steps = DEVGEN_BATCHES * DEVGEN_SUB
    events = DEVGEN_BATCH * DEVGEN_BATCHES
    on_path = ("nexmark_bids", "devgen_ingest", "window_counts",
               "topn_select_append", "ring_columns")
    runs = []
    for i in range(DEVGEN_RUNS):
        rows, launches, res, wall = run_devgen_q5(torch, np, conf, cfg,
                                                  f"nexmark-q5-devgen-{i}")
        missing = [k for k in on_path if launches[k] == 0]
        check(not missing,
              f"kernels not launched on the devgen path: {missing}")
        check(launches["nexmark_bids"] == n_steps
              and launches["devgen_ingest"] == n_steps,
              f"expected {n_steps} launches of nexmark_bids and "
              f"devgen_ingest, got {launches}")
        check(res.metrics["devgen_host_batches"] == 0,
              f"{res.metrics['devgen_host_batches']} batches went to the host")
        check(res.metrics["records_in"] == events,
              f"records_in {res.metrics['records_in']} != {events}")
        check(len(rows) == len(set(rows)), "duplicate committed rows")
        runs.append((wall, rows, launches, res))
    # the golden's numpy work (GBs of temporaries) comes after the timed
    # runs, so that it cannot slow them
    expect = golden(DEVGEN_BATCHES)
    for i, (_, rows, _, _) in enumerate(runs):
        got = set(rows)
        check(got == expect,
              f"devgen Q5 run {i}: rows differ from the golden: "
              f"{len(got - expect)} extra, {len(expect - got)} missing of "
              f"{len(expect)}")
    rates = [events / r[0] for r in runs]
    wall, rows, launches, res = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    busy = {k.split(".")[-1]: v for k, v in res.metrics.items()
            if k.startswith("device_busy_ms.")}
    host = {k.split(".", 2)[-1]: v for k, v in res.metrics.items()
            if k.startswith("profile.")}
    out = {"phase": "q5_devgen", "conf": "confs/bench_q5_headline.conf",
           "events": events, "logical_batches": DEVGEN_BATCHES,
           "sub_batches": DEVGEN_SUB, "runs": DEVGEN_RUNS,
           "events_per_s_runs": rates,
           "events_per_s": events / wall, "wall_s": wall,
           "wall_ms_per_step": wall * 1e3 / n_steps, "rows": len(rows),
           "windows": len({w for _, w, _ in rows}), "launches": launches,
           "devgen_host_batches": res.metrics["devgen_host_batches"],
           "device_busy_ms": busy,
           "device_busy_ms_per_step": {k: v / n_steps for k, v in busy.items()},
           "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
           "host_profile_s": host,
           "host_ms_per_step": {k: v * 1e3 / n_steps for k, v in host.items()}}

    # the same 4 logical batches at K = 1 (a 64-column pane ring) and
    # K = 4: equal to the golden, and window by window in the same order
    short = dataclasses.replace(cfg, n_batches=DEVGEN_K_BATCHES)
    by_k = {}
    for k in (1, DEVGEN_SUB):
        ck = Configuration.from_file(path).set(PipelineOptions.SUB_BATCHES, k)
        r, l, rk, w = run_devgen_q5(torch, np, ck, short, f"q5-devgen-k{k}")
        check(rk.metrics["devgen_host_batches"] == 0,
              f"K={k}: {rk.metrics['devgen_host_batches']} host batches")
        check(l["nexmark_bids"] == DEVGEN_K_BATCHES * k,
              f"K={k}: {l['nexmark_bids']} nexmark_bids launches")
        by_k[k] = (r, w)
    expect4 = golden(DEVGEN_K_BATCHES)
    r1, r4 = by_k[1][0], by_k[DEVGEN_SUB][0]
    check(set(r1) == expect4 and len(r1) == len(expect4),
          "K=1 rows differ from the golden")
    check(set(r4) == expect4 and len(r4) == len(expect4),
          "K=4 rows differ from the golden")
    # a fire appends rows row-major over all its window ends, so a K = 1
    # advance (~40 ends) and four K = 4 advances (~10 ends each) commit
    # the same rows in another interleave; each window's rows keep one
    # order
    per_window = (sorted(r1, key=lambda r: r[1])
                  == sorted(r4, key=lambda r: r[1]))
    check(per_window, "K=1 and K=4 rows differ window by window")
    out["profiled"] = profile_devgen(torch, np, path, short)
    out["k_compare"] = {
        "logical_batches": DEVGEN_K_BATCHES, "rows": len(r1),
        "equal_window_by_window": per_window,
        "equal_in_commit_order": r1 == r4,
        "events_per_s": {str(k): DEVGEN_BATCH * DEVGEN_K_BATCHES / w
                         for k, (_, w) in by_k.items()}}
    emit(out)
    return launches, out["profiled"]["device_ms_per_call"]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "flink_tpu_torch")):
        print(f"chip_smoke: flink_tpu_torch/ not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        phase_build()
        table = phase_kernels(torch, np)
        host_fed = phase_q5(torch, np)
        devgen, per_call = phase_q5_devgen(torch, np)
        for row in table:
            # device time per call inside the profiled devgen run (the
            # "ms" above is a launch loop, host-bound for short kernels)
            row["pipeline_device_ms"] = per_call.get(row["name"])
            # the headline (devgen) path's count; scatter_counts runs
            # only on the host-fed path
            row["launches"] = devgen[row["name"]] or host_fed[row["name"]]
            row["launches_by_path"] = {"q5_host_fed": host_fed[row["name"]],
                                       "q5_devgen": devgen[row["name"]]}
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
