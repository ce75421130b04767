"""The port's FileSystem registry and plugin loader
(``flink_tpu_torch/fs.py``): ``tests/test_fs.py``'s plugin-loader cases
and its checkpoint storage on a custom scheme, against the port, with
the reference reading back what the port wrote; ``objstore`` resolving
by default, and ``plugins.modules`` loaded by the environment."""
import os
import pickle
import sys
import types

import numpy as np
import pytest

from flink_tpu import fs as jax_fs
from flink_tpu.checkpoint.storage import FsCheckpointStorage as JaxStorage
from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage
from flink_tpu_torch.fs import (
    LocalFileSystem, cas_capable, get_filesystem, load_plugins,
    register_filesystem, schemes)
from test_torch_threads import capped_torch_threads  # noqa: F401


class TestPluginLoader:
    def test_register_and_resolve_custom_scheme(self, tmp_path):
        class MemFs(LocalFileSystem):
            @staticmethod
            def _strip(path):
                return path.replace("testmem://", str(tmp_path) + "/")

        register_filesystem("testmem", MemFs)
        assert "testmem" in schemes()
        fs = get_filesystem("testmem://data/f")
        fs.mkdirs("testmem://data")
        with fs.open_write("testmem://data/f") as f:
            f.write(b"ok")
        assert (tmp_path / "data" / "f").read_bytes() == b"ok"

    def test_load_plugins_runs_register_hook(self, monkeypatch):
        mod = types.ModuleType("fake_fs_plugin")
        calls = []
        mod.register = lambda reg: calls.append(reg)
        monkeypatch.setitem(sys.modules, "fake_fs_plugin", mod)
        assert load_plugins(["fake_fs_plugin", " "]) == ["fake_fs_plugin"]
        assert len(calls) == 1

    def test_plugin_without_hook_raises(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "bad_plugin",
                            types.ModuleType("bad_plugin"))
        with pytest.raises(ValueError, match="register"):
            load_plugins(["bad_plugin"])

    def test_missing_plugin_module_raises_at_load(self):
        with pytest.raises(ModuleNotFoundError):
            load_plugins(["no_such_plugin_module_anywhere"])

    def test_unknown_scheme_names_both_remedies(self):
        with pytest.raises(ValueError, match="plugins.modules") as port:
            get_filesystem("nosuchscheme://x")
        with pytest.raises(ValueError) as ref:
            jax_fs.get_filesystem("nosuchscheme://x")
        # the known schemes differ with what a test registered; the
        # remedy text is the reference's
        assert (str(port.value).split("); ")[1]
                == str(ref.value).split("); ")[1])


class TestDefaultSchemes:
    def test_objstore_resolves_without_plugin_config(self):
        from flink_tpu_torch.fs_objstore import ObjectStoreFileSystem

        assert {"file", "objstore"} <= set(schemes())
        fs = get_filesystem("objstore:///x/y")
        assert isinstance(fs, ObjectStoreFileSystem) and cas_capable(fs)
        assert not cas_capable(get_filesystem("/x/y"))
        assert ({"file", "objstore"} <= set(jax_fs.schemes()))

    def test_plugins_modules_loaded_by_environment(self, monkeypatch):
        from flink_tpu_torch.api.environment import \
            StreamExecutionEnvironment
        from flink_tpu_torch.config import Configuration

        mod = types.ModuleType("env_fs_plugin")
        calls = []
        mod.register = lambda reg: calls.append(reg.schemes())
        monkeypatch.setitem(sys.modules, "env_fs_plugin", mod)
        Configuration({"plugins.modules": "env_fs_plugin"}).validate()
        StreamExecutionEnvironment(Configuration(
            {"plugins.modules": "env_fs_plugin, "}))
        assert len(calls) == 1 and "objstore" in calls[0]
        monkeypatch.setitem(sys.modules, "hookless_plugin",
                            types.ModuleType("hookless_plugin"))
        with pytest.raises(ValueError, match="register"):
            StreamExecutionEnvironment(Configuration(
                {"plugins.modules": "hookless_plugin"}))


class TestStorageThroughSeam:
    def test_checkpoint_storage_on_custom_scheme(self, tmp_path):
        """The whole checkpoint lifecycle (save/list/load/retire) runs on
        a plugin filesystem — nothing in storage touches os directly —
        and the reference loads what the port wrote, through its own
        registration of the same scheme."""
        root = str(tmp_path / "backing")

        def shim(base):
            class ShimFs(base):
                @staticmethod
                def _strip(path):
                    return path.replace("shim://", root + "/")
            return ShimFs

        register_filesystem("shim", shim(LocalFileSystem))
        jax_fs.register_filesystem("shim", shim(jax_fs.LocalFileSystem))
        st = FsCheckpointStorage("shim://ckpts", "job")
        for cid in (1, 2, 3, 4, 5):
            st.save_v2(cid, {"op_versions": {"0": cid}},
                       {"0": pickle.dumps({"v": np.arange(cid)})}, {})
        hs = st.list_complete()
        assert [h.checkpoint_id for h in hs] == [3, 4, 5]  # retained=3
        payload = FsCheckpointStorage.load(st.latest())
        assert list(payload["operators"][0]["v"]) == [0, 1, 2, 3, 4]
        assert payload["op_files"][0].startswith("shim://")
        assert os.path.isdir(os.path.join(root, "ckpts"))
        ref = JaxStorage("shim://ckpts", "job")
        assert [h.checkpoint_id for h in ref.list_complete()] == [3, 4, 5]
        ref_payload = JaxStorage.load(ref.latest())
        assert list(ref_payload["operators"][0]["v"]) == [0, 1, 2, 3, 4]
