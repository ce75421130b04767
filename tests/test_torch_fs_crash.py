"""The port's CrashFS (``flink_tpu_torch/fs_crash.py``): the eight cases
of ``tests/test_fs_crash.py`` (journal recording, POSIX-legal image
materialization, determinism, injectable device errors) against the
port, and a parity case: the same operations through both packages'
CrashFS, cut at the same index with the same seed, give equal
``decisions`` and equal image trees."""
import errno
import os
import random

import numpy as np
import pytest

from flink_tpu import fs as jax_fs
from flink_tpu import fs_crash as jax_fs_crash
from flink_tpu_torch import fs as port_fs
from flink_tpu_torch import fs_crash
from flink_tpu_torch.fs import write_atomic
from flink_tpu_torch.fs_crash import BLOCK, CrashFS
from test_torch_threads import capped_torch_threads  # noqa: F401


@pytest.fixture
def cfs(tmp_path):
    root = os.path.join(str(tmp_path), "root")
    c = CrashFS(root)
    yield c
    c.close()


def _p(cfs, *parts):
    return os.path.join("crash://" + cfs.root, *parts)


class TestJournal:
    def test_records_every_mutation_kind(self, cfs, tmp_path):
        cfs.mkdirs(_p(cfs, "d"))
        with cfs.open_write(_p(cfs, "d", "a"), sync=True) as f:
            f.write(b"x" * 10)
        cfs.fsync(_p(cfs, "d"))
        cfs.rename(_p(cfs, "d", "a"), _p(cfs, "d", "b"))
        cfs.link_or_copy(_p(cfs, "d", "b"), _p(cfs, "d", "c"))
        cfs.delete(_p(cfs, "d", "c"))
        kinds = [op.kind for op in cfs.journal]
        assert kinds == ["mkdir", "write", "fsync", "rename", "link",
                        "delete"]
        # the dir fsync is flagged as one (entry durability)
        assert cfs.journal[2].dir is True
        # live tree behaves normally
        assert cfs.exists(_p(cfs, "d", "b"))
        assert not cfs.exists(_p(cfs, "d", "c"))

    def test_base_snapshot_survives_every_image(self, tmp_path):
        root = os.path.join(str(tmp_path), "root")
        os.makedirs(root)
        with open(os.path.join(root, "pre.txt"), "wb") as f:
            f.write(b"pre-journal history")
        cfs = CrashFS(root)
        try:
            with cfs.open_write(_p(cfs, "new"), sync=False) as f:
                f.write(b"volatile")
            for seed in range(10):
                img = os.path.join(str(tmp_path), "img")
                cfs.crash(img, seed=seed)
                with open(os.path.join(img, "pre.txt"), "rb") as f:
                    assert f.read() == b"pre-journal history"
        finally:
            cfs.close()


class TestMaterialization:
    def test_write_atomic_is_durable_whole_in_every_image(self, cfs,
                                                          tmp_path):
        """The full discipline (content fsync + rename + parent-dir
        fsync) survives ANY crash point at or after the dir fsync; at
        every earlier cut the final name holds either nothing or the
        whole content — never a torn file."""
        payload = b"A" * (BLOCK * 2 + 17)
        write_atomic(cfs, _p(cfs, "pub.json"), payload)
        n = len(cfs.journal)
        img = os.path.join(str(tmp_path), "img")
        for seed in range(20):
            cfs.crash(img, at=n, rng=random.Random(seed))
            p = os.path.join(img, "pub.json")
            assert os.path.exists(p)
            with open(p, "rb") as f:
                assert f.read() == payload
        # earlier cuts: absent or whole, never torn at the final name
        for cut in range(n):
            for seed in range(5):
                cfs.crash(img, at=cut, rng=random.Random(seed))
                p = os.path.join(img, "pub.json")
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        assert f.read() == payload

    def test_unsynced_write_survivals_are_legal(self, cfs, tmp_path):
        """An unsynced write may land absent, empty, a block-multiple
        prefix, torn (zeroed partial block), or full — nothing else."""
        payload = bytes(range(256)) * ((BLOCK * 3) // 256 + 1)
        with cfs.open_write(_p(cfs, "v"), sync=False) as f:
            f.write(payload)
        img = os.path.join(str(tmp_path), "img")
        seen = set()
        for seed in range(60):
            cfs.crash(img, at=len(cfs.journal),
                      rng=random.Random(seed))
            p = os.path.join(img, "v")
            if not os.path.exists(p):
                seen.add("absent")
                continue
            with open(p, "rb") as f:
                got = f.read()
            if got == payload:
                seen.add("full")
            elif got == b"":
                seen.add("empty")
            elif got == payload[:len(got)]:
                assert len(got) % BLOCK == 0
                seen.add("prefix")
            else:
                # torn: block prefix + zeroed tail
                keep = (len(got) // BLOCK) * BLOCK if len(got) % BLOCK \
                    else len(got) - BLOCK
                assert got[:keep] == payload[:keep]
                assert got[keep:] == b"\x00" * (len(got) - keep)
                seen.add("torn")
        # the sampler actually explores the space
        assert {"absent", "full"} <= seen and len(seen) >= 4

    def test_unsynced_rename_may_unapply_synced_never(self, cfs,
                                                      tmp_path):
        with cfs.open_write(_p(cfs, "t.tmp"), sync=True) as f:
            f.write(b"data")
        cfs.rename(_p(cfs, "t.tmp"), _p(cfs, "t"))  # no dir fsync
        img = os.path.join(str(tmp_path), "img")
        outcomes = set()
        for seed in range(30):
            cfs.crash(img, at=len(cfs.journal),
                      rng=random.Random(seed))
            at_tmp = os.path.exists(os.path.join(img, "t.tmp"))
            at_dst = os.path.exists(os.path.join(img, "t"))
            assert at_tmp != at_dst  # exactly one name, content durable
            outcomes.add("dst" if at_dst else "tmp")
            with open(os.path.join(
                    img, "t" if at_dst else "t.tmp"), "rb") as f:
                assert f.read() == b"data"
        assert outcomes == {"dst", "tmp"}
        # now make the rename entry-durable: every image keeps dst
        cfs.fsync("crash://" + cfs.root)
        for seed in range(15):
            cfs.crash(img, at=len(cfs.journal),
                      rng=random.Random(seed))
            assert os.path.exists(os.path.join(img, "t"))
            assert not os.path.exists(os.path.join(img, "t.tmp"))

    def test_same_seed_same_cut_is_deterministic(self, cfs, tmp_path):
        for i in range(4):
            with cfs.open_write(_p(cfs, f"f{i}"), sync=False) as f:
                f.write(os.urandom(BLOCK * 2))
            cfs.rename(_p(cfs, f"f{i}"), _p(cfs, f"g{i}"))

        def image_state(img):
            out = {}
            for root, _, files in os.walk(img):
                for fn in files:
                    p = os.path.join(root, fn)
                    with open(p, "rb") as f:
                        out[os.path.relpath(p, img)] = f.read()
            return out

        a = os.path.join(str(tmp_path), "a")
        b = os.path.join(str(tmp_path), "b")
        da = cfs.crash(a, at=5, rng=random.Random(99))
        db = cfs.crash(b, at=5, rng=random.Random(99))
        assert da == db
        assert image_state(a) == image_state(b)


class TestInjection:
    def test_enospc_on_write(self, cfs):
        cfs.fail("write", errno.ENOSPC, count=1)
        with pytest.raises(OSError) as ei:
            with cfs.open_write(_p(cfs, "x"), sync=False) as f:
                f.write(b"data")
        assert ei.value.errno == errno.ENOSPC
        # one-shot: the next write succeeds
        with cfs.open_write(_p(cfs, "x"), sync=False) as f:
            f.write(b"data")

    def test_eio_on_fsync_and_rename_with_after(self, cfs):
        with cfs.open_write(_p(cfs, "a"), sync=False) as f:
            f.write(b"1")
        cfs.fail("fsync", errno.EIO, count=1)
        with pytest.raises(OSError) as ei:
            cfs.fsync(_p(cfs, "a"))
        assert ei.value.errno == errno.EIO
        cfs.fail("rename", errno.EIO, count=1, after=1)
        cfs.rename(_p(cfs, "a"), _p(cfs, "b"))  # skipped by after=1
        with pytest.raises(OSError):
            cfs.rename(_p(cfs, "b"), _p(cfs, "c"))


def _image_state(img):
    out = {}
    for root, dirs, files in os.walk(img):
        for d in dirs:
            out[os.path.relpath(os.path.join(root, d), img) + "/"] = None
        for fn in files:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, img)] = f.read()
    return out


def _mutations(pkg_fs, cfs, payloads):
    """One mixed schedule through a CrashFS: synced and unsynced
    writes, write_atomic publishes, renames with and without a
    directory fsync, a link and deletes."""
    cfs.mkdirs(_p(cfs, "d", "e"))
    pkg_fs.write_atomic(cfs, _p(cfs, "d", "pub.json"), payloads[0])
    for i, data in enumerate(payloads[1:]):
        with cfs.open_write(_p(cfs, "d", f"f{i}"), sync=i % 2 == 0) as f:
            f.write(data)
        cfs.rename(_p(cfs, "d", f"f{i}"), _p(cfs, "d", "e", f"g{i}"))
        if i % 3 == 1:
            cfs.fsync(_p(cfs, "d", "e"))
    cfs.link_or_copy(_p(cfs, "d", "e", "g0"), _p(cfs, "d", "h"))
    cfs.delete(_p(cfs, "d", "e", "g1"))
    cfs.fsync(_p(cfs, "d", "e", "g2"))
    cfs.delete(_p(cfs, "d", "e"), recursive=True)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_schedule_same_decisions_and_trees_as_reference(tmp_path,
                                                             seed):
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, int(n), np.uint8).tobytes()
                for n in rng.integers(0, 3 * BLOCK, 7)]
    pairs = []
    for name, mod, pkg_fs in (("port", fs_crash, port_fs),
                              ("ref", jax_fs_crash, jax_fs)):
        c = mod.CrashFS(os.path.join(str(tmp_path), name, "root"))
        try:
            _mutations(pkg_fs, c, payloads)
            out = []
            for cut in range(0, len(c.journal) + 1, 3):
                img = os.path.join(str(tmp_path), name, f"img-{cut}")
                dec = c.crash(img, at=cut, seed=seed,
                              rng=random.Random(seed * 1000 + cut))
                out.append((dec, _image_state(img)))
            full = c.crash(os.path.join(str(tmp_path), name, "img-rng"),
                           seed=seed)
            out.append((full, _image_state(
                os.path.join(str(tmp_path), name, "img-rng"))))
            pairs.append(([(op.kind, op.path, op.dst, op.data, op.fid,
                            op.sync, op.recursive, op.dir)
                           for op in c.journal], out))
        finally:
            c.close()
    (port_journal, port_images), (ref_journal, ref_images) = pairs
    assert port_journal == ref_journal
    assert len(port_images) == len(ref_images) > 3
    for (pd, pt), (rd, rt) in zip(port_images, ref_images):
        assert pd == rd
        assert pt == rt
