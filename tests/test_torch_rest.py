"""``tests/test_rest.py`` against the port's REST API
(``flink_tpu_torch/obs/rest.py``; ref: rest/RestServerEndpoint +
dispatcher handler tests: jobs overview, job detail, cancellation,
savepoint trigger, the job graph), the flame graph's thread sampler, and
``TestAgainstTheReference``: the same coordinator state behind each
package's server answers every route with the same status and JSON."""
import json
import urllib.error
import urllib.request

import pytest

from flink_tpu_torch.config import Configuration
from flink_tpu_torch.obs.rest import RestServer
from flink_tpu_torch.runtime.coordinator import JobCoordinator


@pytest.fixture
def cluster():
    coord = JobCoordinator(Configuration())
    rest = RestServer(coord, port=0)
    yield coord, rest
    rest.close()
    coord.close()


def get(rest, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{rest.port}{path}") as r:
        return r.status, json.loads(r.read())


def req(rest, method, path):
    r = urllib.request.Request(
        f"http://127.0.0.1:{rest.port}{path}", method=method)
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestRest:
    def test_overview_and_jobs(self, cluster):
        coord, rest = cluster
        coord.rpc_register_runner("r1", "127.0.0.1", 8, 0)
        coord.rpc_submit_job("job-a")
        code, body = get(rest, "/overview")
        assert code == 200
        assert body["taskmanagers"] == 1
        assert body["jobs"] == {"RUNNING": 1}

        code, body = get(rest, "/jobs")
        assert [j["job_id"] for j in body["jobs"]] == ["job-a"]

        code, body = get(rest, "/jobs/job-a")
        assert code == 200 and body["state"] == "RUNNING"

        code, body = get(rest, "/taskmanagers")
        assert "r1" in body["taskmanagers"]

    def test_unknown_job_404(self, cluster):
        _, rest = cluster
        code, body = req(rest, "GET", "/jobs/nope")
        assert code == 404

    def test_cancel_via_patch(self, cluster):
        coord, rest = cluster
        coord.rpc_submit_job("job-b")
        code, body = req(rest, "PATCH", "/jobs/job-b?mode=cancel")
        assert code == 202 and body["ok"]
        assert coord.rpc_job_status("job-b")["state"] == "CANCELED"
        code, _ = req(rest, "PATCH", "/jobs/job-b?mode=explode")
        assert code == 400

    def test_savepoint_trigger_conflict_when_not_running(self, cluster):
        coord, rest = cluster
        coord.rpc_submit_job("job-c")
        coord.rpc_cancel_job("job-c")
        code, body = req(rest, "POST", "/jobs/job-c/savepoints")
        assert code == 409 and not body["ok"]

    def test_html_index(self, cluster):
        # client-rendered dashboard: the page ships the fetch/render
        # logic; the DATA arrives from the JSON routes it polls
        coord, rest = cluster
        coord.rpc_submit_job("job-d")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rest.port}/") as r:
            html = r.read().decode()
        assert "flink_tpu_torch" in html and "/graph" in html
        code, jobs = req(rest, "GET", "/jobs")
        assert code == 200
        assert any(j["job_id"] == "job-d" for j in jobs["jobs"])

    def test_unknown_route_404(self, cluster):
        _, rest = cluster
        code, _ = req(rest, "GET", "/nonexistent")
        assert code == 404

    def test_patch_and_savepoint_unknown_job_404(self, cluster):
        _, rest = cluster
        code, _ = req(rest, "PATCH", "/jobs/typo?mode=cancel")
        assert code == 404
        code, _ = req(rest, "POST", "/jobs/typo/savepoints")
        assert code == 404

    def test_html_escapes_job_ids(self, cluster):
        coord, rest = cluster
        coord.rpc_submit_job("<script>alert(1)</script>")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rest.port}/") as r:
            html = r.read().decode()
        # the page never embeds job ids server-side; every client-side
        # interpolation routes through the esc() helper
        assert "<script>alert" not in html
        assert "function esc(" in html
        assert "esc(jb.job_id)" in html

    def test_dispatch_through_rpc_server(self):
        """REST fronted by the RpcServer rides its single dispatch
        thread (the documented no-locks contract)."""
        from flink_tpu_torch.runtime.rpc import RpcServer

        coord = JobCoordinator(Configuration())
        srv = RpcServer(coord)
        rest = RestServer(srv, port=0)
        try:
            coord.rpc_submit_job("via-rpc")
            code, body = get(rest, "/jobs/via-rpc")
            assert code == 200 and body["state"] == "RUNNING"
        finally:
            rest.close()
            srv.close()
            coord.close()


class TestJobGraphRoute:
    def test_graph_route_serves_dag_and_metrics(self, cluster):
        coord, rest = cluster
        coord.rpc_submit_job("job-g")
        coord.rpc_report_plan("job-g", ["source", "window", "sink"])
        coord.jobs["job-g"].last_metrics = {
            "eps": 123.0, "records_in": 10, "records_out": 5,
            "wm_lag_ms": 7, "backpressure_s": 0.1,
            "checkpoints": [{"id": 1, "ts": 0, "bytes": 100}]}
        code, g = req(rest, "GET", "/jobs/job-g/graph")
        assert code == 200
        assert g["stages"] == ["source", "window", "sink"]
        assert g["metrics"]["eps"] == 123.0
        assert g["metrics"]["checkpoints"][0]["id"] == 1


class TestAgainstTheReference:
    """The same coordinator state in each package, behind each
    package's REST server: every JSON reply equal, status code
    included."""

    @staticmethod
    def _state(pkg):
        import importlib

        coordinator = importlib.import_module(f"{pkg}.runtime.coordinator")
        config = importlib.import_module(f"{pkg}.config")
        rest = importlib.import_module(f"{pkg}.obs.rest")
        coord = coordinator.JobCoordinator(config.Configuration())
        coord.rpc_register_runner("r1", "127.0.0.1", 8, 0)
        coord.rpc_register_runner("r2", "127.0.0.1", 4, 0)
        coord.rpc_submit_job("job-a")
        coord.rpc_submit_job("job-b")
        coord.rpc_report_plan("job-a", ["source", "window", "sink"])
        coord.jobs["job-a"].last_metrics = {
            "eps": 5.0, "records_in": 3, "records_out": 2,
            "checkpoints": [{"id": 1, "ts": 0, "bytes": 10}]}
        coord.rpc_submit_job("job-c")
        coord.rpc_cancel_job("job-c")
        return coord, rest.RestServer(coord, port=0)

    ROUTES = (
        ("GET", "/overview"), ("GET", "/jobs"), ("GET", "/jobs/job-a"),
        ("GET", "/jobs/job-c"), ("GET", "/jobs/job-a/graph"),
        ("GET", "/jobs/nope/graph"), ("GET", "/jobs/nope"),
        ("GET", "/traces?name=no-such-span"), ("GET", "/nonexistent"),
        ("POST", "/jobs/job-c/savepoints"), ("POST", "/jobs/nope/savepoints"),
        ("PATCH", "/jobs/job-a?mode=explode"),
        ("PATCH", "/jobs/job-a?mode=rescale"),
        ("PATCH", "/jobs/job-a?mode=rescale&devices=2&processes=x"),
        ("PATCH", "/jobs/nope?mode=cancel"),
        ("PATCH", "/jobs/job-b?mode=cancel"), ("GET", "/jobs/job-b"),
        ("GET", "/overview"), ("POST", "/nonexistent"),
    )

    @staticmethod
    def _strip_times(obj):
        if isinstance(obj, dict):
            return {k: TestAgainstTheReference._strip_times(v)
                    for k, v in obj.items()
                    if k not in ("last_heartbeat", "submitted_at",
                                 "started_at", "finished_at", "ts")}
        if isinstance(obj, list):
            return [TestAgainstTheReference._strip_times(v) for v in obj]
        return obj

    def test_replies_equal_the_reference(self):
        got = {}
        for pkg in ("flink_tpu", "flink_tpu_torch"):
            coord, rest = self._state(pkg)
            try:
                got[pkg] = [(m, p, *req(rest, m, p)) for m, p in self.ROUTES]
            finally:
                rest.close()
                coord.close()
        ref = self._strip_times(got["flink_tpu"])
        assert self._strip_times(got["flink_tpu_torch"]) == ref
        codes = {(m, p): c for m, p, c, _ in ref}
        assert codes[("GET", "/jobs/job-a/graph")] == 200
        assert codes[("PATCH", "/jobs/job-b?mode=cancel")] == 202
        assert codes[("POST", "/jobs/job-c/savepoints")] == 409

    def test_flamegraph_samples_the_threads(self):
        import threading

        coord, rest = self._state("flink_tpu_torch")
        stop = threading.Event()
        worker = threading.Thread(target=stop.wait, args=(5,),
                                  name="sampled")
        worker.start()
        try:
            code, body = req(rest, "GET", "/flamegraph?seconds=0.2&hz=50")
            assert code == 200
            assert body["samples"] > 0 and body["hz"] == 50.0
            assert any("wait@threading.py" in st for st in body["stacks"])
        finally:
            stop.set()
            worker.join()
            rest.close()
            coord.close()
