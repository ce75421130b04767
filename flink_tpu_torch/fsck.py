"""Storage fsck: offline integrity checks of the durable tiers, the JAX
package's ``fsck``. ``fsck_path(path, repair=)`` detects what ``path``
holds (``detect_kind``): a log topic directory, a checkpoint directory
(a job directory of ``chk-*`` children, one checkpoint, or a storage
root of job directories) or an LSM state store (a ``MANIFEST.json`` of
format ``lsm-state``), and verifies what the online readers assume:

- segments: every committed or compacted columnar file decodes whole
  (block CRCs, the footer) with the rows its marker promised;
- coherence: committed offsets contiguous above the floor, the
  compaction manifest's files present and covering its ranges, a
  pre-commit marker without its commit (a staged transaction), leases
  that parse and have not expired unreleased;
- coordination records: consumer-group membership manifests parse, and
  no generation-keyed offset runs ahead of its group's manifest; the
  cleaner's lease parses and is flagged when it expired unreleased;
- orphans: ``.tmp`` debris, segments no marker or manifest references,
  ``.inprogress`` and manifest-less checkpoint directories, the object
  store's ``*.lock~`` scratch;
- LSM stores: every listed run exists and decodes whole with its rows,
  the seq counter covers every run, run names are unique.

``repair=True`` applies only the sweeps the online recovery paths would
make: it deletes repairable orphans older than ``REPAIR_MIN_AGE_S``
(a live writer's fresh file looks like debris), topic and LSM sweeps
under the maintenance lock, and never a marker, a lease, an offset or a
file a marker or manifest names.

A finding is a dict: ``rule``, ``severity`` (error | warn), ``path``,
``message``, ``repairable`` and ``repaired``. ``main(args)`` is the
command's half, with the JAX package's exit codes (0 clean, 1
findings, 2 an unrecognised path); it takes an ``argparse.Namespace``
with ``path``, ``repair`` and ``json`` until the command line comes
(ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from flink_tpu_torch.formats_columnar import ColumnarError, iter_blocks
from flink_tpu_torch.fs import get_filesystem
from flink_tpu_torch.log.topic import (
    GROUP_DIR,
    LEASE_DIR,
    OFFSET_COL,
    _CMP_RE,
    _SEG_RE,
    LogError,
    _list_markers,
    _partition_dir,
    _read_json,
    _txn_dir,
    load_manifest,
)

__all__ = ["fsck_path", "fsck_topic", "fsck_checkpoints", "main"]


# a repairable topic FILE younger than this is skipped by --repair:
# between a live producer's segment rename and its pre-commit marker
# the file is indistinguishable from debris (the stage-window grace)
REPAIR_MIN_AGE_S = 60.0


def _older_than(path: str, age_s: float) -> bool:
    from flink_tpu_torch.log.topic import _local_path

    local = _local_path(path)
    if local is None:
        return True  # non-local: no mtime to consult — lease guard
        # and the maintenance lock remain the protections
    try:
        return (time.time() - os.path.getmtime(local)) > age_s
    except OSError:
        return False  # vanished/unstattable: do not touch it


def _f(rule: str, severity: str, path: str, message: str,
       repairable: bool = False) -> Dict[str, Any]:
    return {"rule": rule, "severity": severity, "path": path,
            "message": message, "repairable": repairable,
            "repaired": False}


def _classify_columnar(e: Exception) -> str:
    msg = str(e).lower()
    if "crc" in msg:
        return "SEGMENT_CRC"
    if "truncat" in msg or "footer" in msg or "empty columnar" in msg:
        return "SEGMENT_TRUNCATED"
    return "SEGMENT_CORRUPT"


def _verify_segment(fs, path: str, schema, promised_rows: Optional[int],
                    findings: List[Dict[str, Any]]) -> None:
    """Full decode pass: header + every block CRC + footer; row count
    vs the marker/manifest promise."""
    try:
        with fs.open_read(path) as f:
            data = f.read()
        if isinstance(data, str):
            data = data.encode("utf-8")
        rows = 0
        for block in iter_blocks(data, expect_schema=schema):
            rows += len(next(iter(block.values()), ()))
        if promised_rows is not None and rows != promised_rows:
            findings.append(_f(
                "SEGMENT_ROWS_MISMATCH", "error", path,
                f"segment holds {rows} rows, its marker promised "
                f"{promised_rows}"))
    except OSError as e:
        findings.append(_f("SEGMENT_MISSING", "error", path,
                           f"referenced segment unreadable: {e}"))
    except ColumnarError as e:
        findings.append(_f(_classify_columnar(e), "error", path,
                           f"segment fails verification: {e}"))


# -- topic --------------------------------------------------------------

def fsck_topic(path: str) -> List[Dict[str, Any]]:
    fs = get_filesystem(path)
    findings: List[Dict[str, Any]] = []
    try:
        meta = _read_json(fs, os.path.join(path, "meta.json"),
                          "topic meta")
        partitions = int(meta["partitions"])
    except (LogError, OSError, KeyError, ValueError) as e:
        return [_f("CORRUPT_CONTROL", "error",
                   os.path.join(path, "meta.json"),
                   f"unparseable topic meta: {e}")]

    # markers (loud parse -> finding, not a crash)
    try:
        pres = _list_markers(fs, path, "pre")
        commits = _list_markers(fs, path, "commit")
    except LogError as e:
        return findings + [_f("CORRUPT_CONTROL", "error",
                              _txn_dir(path),
                              f"unparseable transaction marker: {e}")]

    schema = None
    for key in sorted(commits):
        if commits[key].get("schema"):
            schema = tuple((str(n), str(t))
                           for n, t in commits[key]["schema"])
    sparse_schema = ((OFFSET_COL, "i64"),) + schema if schema else None

    # compaction manifest FIRST: it defines the per-partition floor
    # below which commit-marker segments are legitimately superseded
    try:
        manifest = load_manifest(fs, path)
    except LogError as e:
        manifest = None
        findings.append(_f("CORRUPT_CONTROL", "error",
                           os.path.join(path, "manifest.json"),
                           f"unparseable compaction manifest: {e}"))
    live_cmp: Dict[int, set] = {p: set() for p in range(partitions)}
    floor: Dict[int, int] = {p: 0 for p in range(partitions)}
    if manifest is not None:
        for p, entry in manifest.get("partitions", {}).items():
            p = int(p)
            floor[p] = max(int(entry.get("start", 0)),
                           int(entry.get("compacted_end", 0)))
            at = int(entry.get("start", 0))
            for s in entry.get("segments", []):
                live_cmp.setdefault(p, set()).add(s["name"])
                seg = os.path.join(_partition_dir(path, p), s["name"])
                if not fs.exists(seg):
                    findings.append(_f(
                        "MANIFEST_SEGMENT_MISSING", "error", seg,
                        f"manifest gen {manifest['gen']} references a "
                        "compacted segment that does not exist"))
                else:
                    _verify_segment(fs, seg, sparse_schema,
                                    int(s["rows"]), findings)
                if int(s["base"]) < at:
                    findings.append(_f(
                        "MANIFEST_INCOHERENT", "error", seg,
                        f"compacted segment covers [{s['base']}, "
                        f"{s['end']}) below the running floor {at}"))
                at = int(s["end"])

    # committed segments: existence + CRC/footer + row promise —
    # EXCEPT ranges wholly below the compaction/retention floor, whose
    # raw files were superseded by the manifest generation (a still-
    # present superseded file is droppable debris, reported as orphan
    # below, not verified as live data)
    referenced: Dict[int, set] = {p: set() for p in range(partitions)}
    for (cid, writer), marker in sorted(commits.items()):
        for p_s, segs in marker.get("segments", {}).items():
            p = int(p_s)
            for s in segs:
                end = int(s["base"]) + int(s["rows"])
                if end <= floor.get(p, 0):
                    continue  # superseded by the manifest generation:
                    # the raw file may legitimately be gone; if still
                    # present it reports as a repairable orphan below
                referenced.setdefault(p, set()).add(s["name"])
                _verify_segment(
                    fs,
                    os.path.join(_partition_dir(path, p), s["name"]),
                    schema, int(s["rows"]), findings)

    # staged (pre-without-commit) markers: orphan candidates
    for (cid, writer), marker in sorted(pres.items()):
        if (cid, writer) in commits:
            continue
        missing = []
        for p_s, segs in marker.get("segments", {}).items():
            for s in segs:
                referenced.setdefault(int(p_s), set()).add(s["name"])
                seg = os.path.join(_partition_dir(path, int(p_s)),
                                   s["name"])
                if not fs.exists(seg):
                    missing.append(s["name"])
        mpath = os.path.join(_txn_dir(path), f"pre-{cid:010d}"
                             + (f"-w.{writer}" if writer else "")
                             + ".json")
        findings.append(_f(
            "ORPHAN_PRE_MARKER", "warn", mpath,
            f"pre-commit marker cid={cid} writer={writer or '<single>'} "
            f"has no commit marker"
            + (f" and {len(missing)} of its staged segments are "
               f"missing ({missing[:3]}...)" if missing else
               " (staged transaction — live producer, or a crashed "
               "attempt recovery will roll back)")))

    # offset-chain coherence above the floor (the TopicReader contract)
    try:
        from flink_tpu_torch.log.topic import TopicReader

        TopicReader(path)
    except (LogError, ColumnarError) as e:
        findings.append(_f("OFFSETS_BROKEN", "error", path,
                           f"committed offset chain is broken: {e}"))
    except OSError:
        pass  # per-segment findings above already name the files

    # orphans: tmp debris + unreferenced segment/cmp files
    for p in range(partitions):
        pdir = _partition_dir(path, p)
        if not fs.exists(pdir):
            continue
        for name in sorted(fs.listdir(pdir)):
            fpath = os.path.join(pdir, name)
            if name.endswith(".tmp"):
                findings.append(_f(
                    "ORPHAN_FILE", "warn", fpath,
                    "write-in-progress debris (crashed writer)",
                    repairable=True))
            elif _SEG_RE.match(name):
                if name not in referenced.get(p, set()):
                    findings.append(_f(
                        "ORPHAN_FILE", "warn", fpath,
                        "segment referenced by no pre/commit marker "
                        "(torn prepare or superseded by compaction)",
                        repairable=True))
            elif _CMP_RE.match(name):
                if name not in live_cmp.get(p, set()):
                    findings.append(_f(
                        "ORPHAN_FILE", "warn", fpath,
                        "compacted segment outside the current "
                        "manifest generation (crashed or superseded "
                        "pass)", repairable=True))

    # leases: parseable, not silently expired
    ldir = os.path.join(path, LEASE_DIR)
    if fs.exists(ldir):
        now = int(time.time() * 1000)
        for name in sorted(fs.listdir(ldir)):
            # the .json suffix also excludes "pN.json.lock" acquire locks
            if not name.endswith(".json"):
                continue
            lpath = os.path.join(ldir, name)
            try:
                rec = _read_json(fs, lpath, "lease file")
            except LogError as e:
                findings.append(_f("CORRUPT_CONTROL", "error", lpath,
                                   f"unparseable lease: {e}"))
                continue
            if (not rec.get("released")
                    and int(rec.get("deadline_ms", 0)) < now):
                findings.append(_f(
                    "STALE_LEASE", "warn", lpath,
                    f"lease held by {rec.get('owner')!r} (epoch "
                    f"{rec.get('epoch')}) expired at "
                    f"{rec.get('deadline_ms')} without release — "
                    "crashed producer; the next acquirer takes over "
                    "at epoch+1"))

    # cleaner service records: lease parseable and not silently
    # expired, published status parseable (a torn status would be a
    # PUT-atomicity violation — the cleaner publishes both via
    # CAS/atomic-rename)
    from flink_tpu_torch.log.cleaner import CLEANER_LEASE, CLEANER_STATUS

    cl_path = os.path.join(path, CLEANER_LEASE)
    if fs.exists(cl_path):
        try:
            rec = _read_json(fs, cl_path, "cleaner lease")
        except LogError as e:
            findings.append(_f("CORRUPT_CONTROL", "error", cl_path,
                               f"unparseable cleaner lease: {e}"))
        else:
            now = int(time.time() * 1000)
            if (not rec.get("released")
                    and int(rec.get("deadline_ms", 0)) < now):
                findings.append(_f(
                    "STALE_CLEANER_LEASE", "warn", cl_path,
                    f"cleaner lease held by {rec.get('owner')!r} "
                    f"(epoch {rec.get('epoch')}) expired at "
                    f"{rec.get('deadline_ms')} without release — "
                    "crashed cleaner service; the next service takes "
                    "over at epoch+1 and its first verify() deposes "
                    "any zombie pass"))
    cs_path = os.path.join(path, CLEANER_STATUS)
    if fs.exists(cs_path):
        try:
            _read_json(fs, cs_path, "cleaner status")
        except LogError as e:
            findings.append(_f("CORRUPT_CONTROL", "error", cs_path,
                               f"unparseable cleaner status: {e}"))

    # consumer-group offsets: parseable, and generation-keyed commits
    # coherent with the group's membership manifest — an offset
    # recorded at a generation the manifest has never reached means
    # the fence was bypassed (or the manifest was rolled back by
    # hand), and the exactly-once handover accounting is suspect
    from flink_tpu_torch.log.bus import ConsumerGroups

    gdir = os.path.join(path, GROUP_DIR)
    if fs.exists(gdir):
        for gname in sorted(fs.listdir(gdir)):
            sub = os.path.join(gdir, gname)
            if not fs.is_dir(sub):
                continue
            manifest_gen: Optional[int] = None
            mpath = os.path.join(sub, ConsumerGroups.MEMBERSHIP)
            if fs.exists(mpath):
                try:
                    mrec = _read_json(fs, mpath,
                                      "group membership manifest")
                    manifest_gen = int(mrec["generation"])
                    if not isinstance(mrec.get("members"), list):
                        raise KeyError("members")
                except (LogError, KeyError, ValueError, TypeError) as e:
                    findings.append(_f(
                        "CORRUPT_CONTROL", "error", mpath,
                        f"unparseable group membership manifest: {e}"))
            for name in sorted(fs.listdir(sub)):
                if (not name.endswith(".json")
                        or name == ConsumerGroups.MEMBERSHIP):
                    continue
                opath = os.path.join(sub, name)
                try:
                    rec = _read_json(fs, opath, "group-offset file")
                    int(rec["offset"])
                except (LogError, KeyError, ValueError, TypeError) as e:
                    findings.append(_f(
                        "CORRUPT_CONTROL", "error", opath,
                        f"unparseable group offset: {e}"))
                    continue
                if "generation" not in rec:
                    continue
                ogen = int(rec["generation"])
                if manifest_gen is None:
                    findings.append(_f(
                        "GROUP_GENERATION_INCOHERENT", "error", opath,
                        f"offset committed at generation {ogen} but "
                        f"group {gname!r} has no membership manifest "
                        "— a generation-keyed commit cannot pass the "
                        "fence without one"))
                elif ogen > manifest_gen:
                    findings.append(_f(
                        "GROUP_GENERATION_INCOHERENT", "error", opath,
                        f"offset committed at generation {ogen} ahead "
                        f"of the membership manifest's {manifest_gen} "
                        "— the fence admits only the current "
                        "generation, so the manifest regressed "
                        "(rolled back or hand-damaged)"))

    # objstore serialization-lock scratch: a crashed conditional put
    # leaves at most one `.lock~` beside the object it was publishing.
    # The fake's listdir hides them (server internals), so the scan
    # walks the raw backing directory; sweepable once the holder is
    # provably gone (maintenance lock + age grace, applied by repair)
    _scan_lock_debris(fs, path, findings)
    return findings


def _scan_lock_debris(fs, path: str,
                      findings: List[Dict[str, Any]]) -> None:
    from flink_tpu_torch.log.topic import _local_path

    local = _local_path(path)
    if local is None:
        backing = getattr(fs, "_backing", None)
        real = getattr(fs, "_real", None)
        if backing is None or real is None:
            return  # remote scheme without a reachable backing dir
        local = real(backing(path))
    if not os.path.isdir(local):
        return
    for dirpath, _dirs, files in os.walk(local):
        for name in sorted(files):
            if name.endswith(".lock~"):
                findings.append(_f(
                    "OBJSTORE_LOCK_DEBRIS", "warn",
                    os.path.join(dirpath, name),
                    "conditional-put serialization scratch left by a "
                    "crashed put_if (server-emulation lock, not a "
                    "durability structure)", repairable=True))


# -- lsm state store ----------------------------------------------------

def fsck_lsm(path: str) -> List[Dict[str, Any]]:
    """Verify an lsm state store directory (state/lsm.py) against its
    manifest — the run files are immutable once published, so a full
    decode pass is exactly what a restoring store would read."""
    findings: List[Dict[str, Any]] = []
    fs = get_filesystem(path)
    mpath = os.path.join(path, "MANIFEST.json")
    try:
        man = _read_json(fs, mpath, "lsm-state manifest")
    except (LogError, OSError) as e:
        return [_f("CORRUPT_CONTROL", "error", mpath,
                   f"unparseable lsm-state manifest: {e}")]
    runs = man.get("runs", [])
    seq = int(man.get("seq", 0))
    seen: set = set()
    for meta in runs:
        name = meta.get("name", "?")
        rpath = os.path.join(path, name)
        if name in seen:
            findings.append(_f(
                "LSM_MANIFEST_INCOHERENT", "error", rpath,
                f"run {name!r} listed twice in the manifest"))
        seen.add(name)
        if int(meta.get("seq", 0)) > seq:
            findings.append(_f(
                "LSM_MANIFEST_INCOHERENT", "error", rpath,
                f"run seq {meta.get('seq')} exceeds the manifest seq "
                f"counter {seq} — a restarting store would re-mint "
                "this live run's name"))
        if not fs.exists(rpath):
            findings.append(_f(
                "LSM_RUN_MISSING", "error", rpath,
                f"manifest gen {man.get('gen')} references a run that "
                "does not exist — the published state is unreadable"))
        else:
            # schema rides the run file itself (run_schema widths are
            # the aggregate's business, not the manifest's)
            _verify_segment(fs, rpath, None,
                            int(meta["rows"]) if "rows" in meta else None,
                            findings)
    for name in sorted(fs.listdir(path)):
        fpath = os.path.join(path, name)
        if name.endswith(".tmp"):
            findings.append(_f(
                "ORPHAN_FILE", "warn", fpath,
                "write-in-progress debris (crashed seal/compact)",
                repairable=True))
        elif (name.startswith("run-") and name.endswith(".seg")
              and name not in seen):
            findings.append(_f(
                "ORPHAN_FILE", "warn", fpath,
                "run referenced by no manifest generation (crashed "
                "pre-swap output, or compaction-replaced and awaiting "
                "the grace sweep)", repairable=True))
    return findings


# -- checkpoints --------------------------------------------------------

def _fsck_one_checkpoint(fs, d: str,
                         findings: List[Dict[str, Any]]) -> None:
    from flink_tpu_torch.checkpoint import blobformat

    mf = os.path.join(d, "MANIFEST.json")
    if not fs.exists(mf):
        findings.append(_f(
            "CHECKPOINT_MANIFEST_MISSING", "error", d,
            "final-name checkpoint dir without MANIFEST.json — "
            "invisible to restore (a power cut between content and "
            "manifest can not produce this under manifest-last; "
            "likely a partially deleted or hand-damaged checkpoint)",
            repairable=True))
        return
    try:
        manifest = _read_json(fs, mf, "checkpoint manifest")
    except LogError as e:
        findings.append(_f("CORRUPT_CONTROL", "error", mf,
                           f"unparseable checkpoint manifest: {e}"))
        return

    def _check_blob(fpath: str) -> None:
        try:
            with fs.open_read(fpath) as f:
                raw = f.read()
        except OSError as e:
            findings.append(_f("CHECKPOINT_BLOB_MISSING", "error",
                               fpath, f"manifest references a missing "
                               f"blob: {e}"))
            return
        if isinstance(raw, str):
            raw = raw.encode()
        comp = manifest.get("compression", "none")
        if comp == "zlib":
            import zlib

            try:
                raw = zlib.decompress(raw)
            except zlib.error as e:
                findings.append(_f("CHECKPOINT_BLOB_CORRUPT", "error",
                                   fpath, f"undecompressable blob: {e}"))
                return
        if blobformat.is_v3(raw):
            try:
                blobformat.decode(raw)
            except Exception as e:  # noqa: BLE001 — any decode death
                findings.append(_f(
                    "CHECKPOINT_BLOB_CORRUPT", "error", fpath,
                    f"blob fails decode: {type(e).__name__}: {e}"))
        elif not raw:
            findings.append(_f("CHECKPOINT_BLOB_CORRUPT", "error",
                               fpath, "zero-byte blob"))

    fmt = int(manifest.get("format_version", 1))
    if fmt == 1 or manifest.get("layout") == "single":
        name = "state.blob" if fmt >= 3 else "state.pkl"
        _check_blob(os.path.join(d, name))
    else:
        _check_blob(os.path.join(
            d, "meta.blob" if fmt >= 3 else "meta.pkl"))
        for nid, entry in manifest.get("ops", {}).items():
            _check_blob(os.path.join(d, entry["file"]))


def fsck_checkpoints(path: str) -> List[Dict[str, Any]]:
    """``path`` is a job dir (chk-* children), one checkpoint dir, or
    a storage root (job dirs of chk-* children)."""
    fs = get_filesystem(path)
    findings: List[Dict[str, Any]] = []

    def _walk_job_dir(jdir: str) -> None:
        for name in sorted(fs.listdir(jdir)):
            d = os.path.join(jdir, name)
            if ".inprogress." in name:
                findings.append(_f(
                    "CHECKPOINT_INPROGRESS_ORPHAN", "warn", d,
                    "abandoned in-progress checkpoint dir (crashed or "
                    "fenced writer)", repairable=True))
            elif name.endswith(".tmp"):
                findings.append(_f("ORPHAN_FILE", "warn", d,
                                   "write-in-progress debris",
                                   repairable=True))
            elif (name.startswith("chk-")
                  or name.startswith("savepoint-")) and fs.is_dir(d):
                _fsck_one_checkpoint(fs, d, findings)

    base = os.path.basename(os.path.normpath(path))
    if base.startswith("chk-") or base.startswith("savepoint-"):
        _fsck_one_checkpoint(fs, path, findings)
        return findings
    names = fs.listdir(path)
    if any(n.startswith(("chk-", "savepoint-")) or ".inprogress." in n
           for n in names):
        _walk_job_dir(path)
        return findings
    # storage root: every child holding chk-* dirs is a job dir
    for name in sorted(names):
        jdir = os.path.join(path, name)
        if fs.is_dir(jdir) and any(
                n.startswith(("chk-", "savepoint-"))
                or ".inprogress." in n for n in fs.listdir(jdir)):
            _walk_job_dir(jdir)
    return findings


# -- entry points -------------------------------------------------------

def detect_kind(path: str) -> Optional[str]:
    """'topic' | 'checkpoint' | 'lsm' | None (unrecognizable)."""
    fs = get_filesystem(path)
    if not fs.exists(path) or not fs.is_dir(path):
        return None
    if fs.exists(os.path.join(path, "meta.json")):
        return "topic"
    mpath = os.path.join(path, "MANIFEST.json")
    if fs.exists(mpath):
        try:
            if _read_json(fs, mpath, "manifest").get(
                    "format") == "lsm-state":
                return "lsm"
        except (LogError, OSError):
            # damaged manifest: run files identify the tier anyway so
            # the lsm scan can REPORT the corruption instead of the
            # path reading as unrecognizable
            if any(n.startswith("run-") and n.endswith(".seg")
                   for n in fs.listdir(path)):
                return "lsm"
    base = os.path.basename(os.path.normpath(path))
    if base.startswith(("chk-", "savepoint-")):
        return "checkpoint"
    names = fs.listdir(path)
    if any(n.startswith(("chk-", "savepoint-")) or ".inprogress." in n
           for n in names):
        return "checkpoint"
    for name in names:
        sub = os.path.join(path, name)
        try:
            if fs.is_dir(sub) and any(
                    n.startswith(("chk-", "savepoint-"))
                    or ".inprogress." in n for n in fs.listdir(sub)):
                return "checkpoint"
        except OSError:
            continue
    return None


def fsck_path(path: str, repair: bool = False) -> List[Dict[str, Any]]:
    """Run the appropriate scan; with ``repair``, apply the safe sweeps
    (delete repairable orphans) and mark them ``repaired``. Raises
    ValueError for an unrecognizable path (the CLI's exit-2 leg)."""
    kind = detect_kind(path)
    if kind is None:
        raise ValueError(
            f"{path!r} is neither a log topic (no meta.json), a "
            "checkpoint directory (no chk-*/savepoint-* children), "
            "nor an lsm state store (no lsm-state MANIFEST.json)")
    findings = (fsck_topic(path) if kind == "topic"
                else fsck_lsm(path) if kind == "lsm"
                else fsck_checkpoints(path))
    if repair:
        fs = get_filesystem(path)
        # topic/lsm repairs run under the maintenance lock: an
        # unreferenced cmp/run file may be a LIVE pass's pre-swap output
        maint_fd = None
        live_leased: set = set()
        if kind == "topic":
            from flink_tpu_torch.log.topic import (
                list_leases, release_maintenance_lock,
                try_maintenance_lock)

            maint_fd = try_maintenance_lock(path)
            now = int(time.time() * 1000)
            live_leased = {
                p for p, rec in list_leases(path).items()
                if not rec.get("released")
                and int(rec.get("deadline_ms", 0)) >= now}
        elif kind == "lsm":
            from flink_tpu_torch.log.topic import try_maintenance_lock

            maint_fd = try_maintenance_lock(path)
            if maint_fd is None:
                return findings  # live seal/compact: nothing is safe
        try:
            for f in findings:
                if not f["repairable"]:
                    continue
                base = os.path.basename(f["path"])
                if f["rule"] == "OBJSTORE_LOCK_DEBRIS":
                    # raw backing-path debris: a live put_if may hold
                    # the lock this instant — sweep only under the
                    # maintenance lock and past the age grace, and
                    # unlink directly (the path is beneath the scheme,
                    # so the topic's fs must not re-map it)
                    if maint_fd is None:
                        continue
                    if not _older_than(f["path"], REPAIR_MIN_AGE_S):
                        continue
                    try:
                        os.unlink(f["path"])
                        f["repaired"] = True
                    except OSError:
                        pass
                    continue
                if kind == "topic":
                    # LIVE-PRODUCER guards: fsck has no writer identity
                    # (sweep_orphans restricts itself to OWNED
                    # partitions for the same window), so an offline
                    # sweep must not race a live stage — between a
                    # segment's rename and its pre marker the file
                    # looks orphaned, and a .tmp may be mid-write.
                    # Skip (a) any partition under a LIVE lease,
                    # (b) files younger than the stage-window grace,
                    # (c) cmp files when the maintenance lock is busy.
                    if maint_fd is None and base.startswith("cmp-"):
                        continue
                    pdir = os.path.basename(os.path.dirname(f["path"]))
                    if (pdir.startswith("p")
                            and pdir[1:].isdigit()
                            and int(pdir[1:]) in live_leased):
                        continue
                    if not _older_than(f["path"], REPAIR_MIN_AGE_S):
                        continue
                elif kind == "lsm":
                    # seal does not hold the maintenance lock — the
                    # age grace is what protects a live store's
                    # rename-pending tmp and pre-manifest run
                    if not _older_than(f["path"], REPAIR_MIN_AGE_S):
                        continue
                try:
                    fs.delete(f["path"], recursive=fs.is_dir(f["path"]))
                    f["repaired"] = True
                except OSError:
                    pass  # report stays repairable-but-unrepaired
        finally:
            if kind in ("topic", "lsm") and maint_fd is not None:
                from flink_tpu_torch.log.topic import release_maintenance_lock

                release_maintenance_lock(path, maint_fd)
    return findings


def render(findings: List[Dict[str, Any]]) -> str:
    if not findings:
        return "fsck: clean (no findings)"
    lines = []
    for f in findings:
        tag = " [repaired]" if f["repaired"] else (
            " [repairable]" if f["repairable"] else "")
        lines.append(f"{f['severity'].upper():5s} {f['rule']}{tag} "
                     f"{f['path']}: {f['message']}")
    return "\n".join(lines)


def main(args) -> int:
    """The command's half: 0 clean, 1 findings, 2 an unrecognised
    path. ``args`` has ``path``, ``repair`` and ``json``."""
    import sys

    try:
        findings = fsck_path(args.path, repair=args.repair)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        for f in findings:
            print(json.dumps(f))
    else:
        print(render(findings))
    # after a repair pass, fully-repaired findings no longer count
    open_findings = [f for f in findings if not f["repaired"]]
    return 1 if open_findings else 0
