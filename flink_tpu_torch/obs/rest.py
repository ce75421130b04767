"""REST API — the coordinator's HTTP face (the JAX package's
``obs/rest.py``: the same routes, status codes and JSON replies).

ref: flink-runtime/.../rest/RestServerEndpoint.java and the dispatcher
handlers (JobsOverviewHandler, JobDetailsHandler, JobCancellationHandler,
SavepointTriggerHandler, TaskManagersHandler). Same resource shapes,
backed by the coordinator's RPC methods — one control-plane brain, two
protocols (ref: WebMonitorEndpoint delegating to the DispatcherGateway).

Routes:
    GET    /overview                      cluster summary
    GET    /jobs                          job list
    GET    /jobs/<id>                     job detail (incl. savepoint)
    PATCH  /jobs/<id>?mode=cancel         cancel
    POST   /jobs/<id>/savepoints          trigger a savepoint
    GET    /taskmanagers                  runner list
    GET    /jobs/<id>/graph               job DAG + live metrics
    PATCH  /jobs/<id>?mode=rescale&devices=N   rescale
    GET    /traces?name=<prefix>          completed spans
    GET    /flamegraph?seconds=S&hz=H     aggregated thread stacks
    GET    /                              minimal HTML overview (Web UI nod)

Binds loopback by default (same rationale as the metrics endpoint:
no unauthenticated control surface on all interfaces by accident).
"""
from __future__ import annotations

import html as html_mod
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse


class RestServer:
    """``target`` is either an RpcServer (preferred: REST calls ride its
    dispatch queue, honoring the single-dispatch-thread discipline) or a
    bare endpoint object — which MUST be internally synchronized, since
    HTTP worker threads then call its rpc_* methods directly
    (JobCoordinator locks internally and qualifies)."""

    def __init__(self, target: Any, port: int = 0,
                 bind: str = "127.0.0.1") -> None:
        if hasattr(target, "dispatch"):
            self._call = target.dispatch
        else:
            self._call = (lambda method, **kw:
                          getattr(target, "rpc_" + method)(**kw))
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _html(self, body: str) -> None:
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:
                code, payload = outer._route("GET", self.path)
                if payload is None:
                    try:
                        self._html(outer._index_html())
                    except Exception as e:  # noqa: BLE001 — HTTP boundary
                        self._send(500, {"error": str(e)})
                else:
                    self._send(code, payload)

            def do_PATCH(self) -> None:
                self._send(*outer._route("PATCH", self.path))

            def do_POST(self) -> None:
                self._send(*outer._route("POST", self.path))

        self._httpd = ThreadingHTTPServer((bind, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    # -- routing ---------------------------------------------------------

    def _route(self, method: str,
               path: str) -> Tuple[int, Optional[Dict[str, Any]]]:
        u = urlparse(path)
        parts = [p for p in u.path.split("/") if p]
        q = parse_qs(u.query)
        try:
            if method == "GET":
                if not parts:
                    return 200, None  # HTML index
                if parts == ["overview"]:
                    runners = self._call("list_runners")
                    jobs = self._call("list_jobs")["jobs"]
                    by_state: Dict[str, int] = {}
                    for j in jobs:
                        by_state[j["state"]] = by_state.get(j["state"], 0) + 1
                    return 200, {
                        "taskmanagers": len(runners),
                        "taskmanagers-alive": sum(
                            1 for r in runners.values() if r["alive"]),
                        "jobs": by_state,
                    }
                if parts == ["jobs"]:
                    return 200, self._call("list_jobs")
                if len(parts) == 2 and parts[0] == "jobs":
                    st = self._call("job_status", job_id=parts[1])
                    if st.get("state") == "UNKNOWN":
                        return 404, {"error": f"no job {parts[1]}"}
                    return 200, {"job_id": parts[1], **st}
                if (len(parts) == 3 and parts[0] == "jobs"
                        and parts[2] == "graph"):
                    # physical DAG + live metrics for the web UI (ref:
                    # the REST job vertices/backpressure endpoints)
                    g = self._call("execution_graph", job_id=parts[1])
                    if not g.get("found"):
                        return 404, {"error": f"no job {parts[1]}"}
                    st = self._call("job_status", job_id=parts[1])
                    g["state"] = st.get("state")
                    g["metrics"] = st.get("metrics")
                    g["rescale"] = st.get("rescale")
                    return 200, g
                if parts == ["taskmanagers"]:
                    return 200, {"taskmanagers": self._call("list_runners")}
                if parts == ["traces"]:
                    from flink_tpu_torch.obs.tracing import tracer

                    prefix = q.get("name", [""])[0]
                    return 200, {"spans": tracer.spans(prefix)}
                if parts == ["flamegraph"]:
                    from flink_tpu_torch.obs.tracing import sample_threads

                    seconds = min(max(
                        float(q.get("seconds", ["1"])[0]), 0.05), 10.0)
                    hz = min(max(float(q.get("hz", ["50"])[0]), 1.0), 200.0)
                    return 200, sample_threads(seconds, hz)
                return 404, {"error": f"no route {u.path}"}
            if method == "PATCH" and len(parts) == 2 and parts[0] == "jobs":
                mode = q.get("mode", ["cancel"])[0]
                st = self._call("job_status", job_id=parts[1])
                if st.get("state") == "UNKNOWN":
                    return 404, {"error": f"no job {parts[1]}"}
                if mode == "cancel":
                    return 202, self._call("cancel_job", job_id=parts[1])
                if mode == "rescale":
                    # ref: the REST rescale endpoint (PATCH with a new
                    # parallelism) driving the AdaptiveScheduler
                    try:
                        devices = int(q.get("devices", [""])[0])
                    except ValueError:
                        return 400, {"error": "rescale needs devices=N"}
                    try:
                        processes = (int(q["processes"][0])
                                     if "processes" in q else None)
                    except ValueError:
                        return 400, {"error": "processes must be an int"}
                    resp = self._call("rescale_job", job_id=parts[1],
                                      devices=devices,
                                      processes=processes)
                    return (202 if resp.get("ok") else 409), resp
                return 400, {"error": f"unsupported mode {mode!r}"}
            if (method == "POST" and len(parts) == 3 and parts[0] == "jobs"
                    and parts[2] == "savepoints"):
                st = self._call("job_status", job_id=parts[1])
                if st.get("state") == "UNKNOWN":
                    return 404, {"error": f"no job {parts[1]}"}
                resp = self._call("trigger_savepoint", job_id=parts[1])
                return (202 if resp.get("ok") else 409), resp
            return 404, {"error": f"no route {method} {u.path}"}
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            return 500, {"error": str(e)}

    def _index_html(self) -> str:
        """The web UI: one static page, no framework, no build step —
        JS fetches /jobs, /jobs/<id>/graph and /taskmanagers every 2s
        and renders the job DAG (stage chain with per-stage execution
        state), throughput/backpressure gauges, and checkpoint history
        (ref: the Flink web dashboard job graph + backpressure tab,
        rendered from the same REST the CLI uses)."""
        return _UI_HTML

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


_UI_HTML = """<!DOCTYPE html>
<html><head><title>flink_tpu_torch</title><style>
body{font-family:system-ui,sans-serif;margin:24px;background:#fafafa}
h1{font-size:20px} h2{font-size:15px;margin:18px 0 6px}
table{border-collapse:collapse;font-size:13px}
td,th{border:1px solid #ccc;padding:3px 8px;text-align:left}
.dag{display:flex;align-items:center;flex-wrap:wrap;margin:6px 0}
.stage{border:1.5px solid #555;border-radius:6px;padding:6px 10px;
  margin:3px;background:#fff;font-size:12px;min-width:110px}
.stage .nm{font-weight:600}
.arrow{margin:0 4px;color:#888;font-size:16px}
.RUNNING{border-color:#2a7} .FAILED{border-color:#c33}
.FINISHED{border-color:#57c} .CANCELED{border-color:#999}
.gauge{display:inline-block;width:120px;height:10px;background:#eee;
  border-radius:5px;overflow:hidden;vertical-align:middle}
.gauge i{display:block;height:100%;background:#e80}
.kv{font-size:12px;color:#333;margin:2px 0}
</style></head><body>
<h1>flink_tpu_torch cluster</h1>
<div id="jobs"></div>
<h2>Runners</h2><div id="runners"></div>
<p style="font-size:11px;color:#777">REST: /overview /jobs
/jobs/&lt;id&gt; /jobs/&lt;id&gt;/graph /taskmanagers — refreshes every 2s</p>
<script>
async function j(u){const r=await fetch(u);return r.json()}
function esc(x){return String(x).replace(/[&<>"']/g,
  c=>({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]))}
function fmtB(n){if(n<0||n==null)return"-";
  return n>1e6?(n/1e6).toFixed(1)+" MB":(n/1e3).toFixed(0)+" KB"}
async function tick(){
  const jobs=(await j("/jobs")).jobs||[];
  let html="";
  for(const jb of jobs){
    const g=await j("/jobs/"+encodeURIComponent(jb.job_id)+"/graph");
    const m=g.metrics||{};
    html+="<h2>job "+esc(jb.job_id)+" — "+esc(g.state||jb.state)+
      " (attempt "+jb.attempts+")</h2>";
    const stages=(g.vertices||[]).reduce((a,v)=>{
      (a[v.stage]=a[v.stage]||[]).push(v);return a},{});
    const names=g.stages||Object.keys(stages);
    html+='<div class="dag">';
    names.forEach((s,i)=>{
      const vs=stages[s]||[];
      const at=vs.length?(vs[0].attempts||vs[0].executions||[]):[];
      const st=at.length?at[at.length-1].state:"?";
      html+='<div class="stage '+esc(st)+'"><div class="nm">'+esc(s)+
        '</div><div>'+vs.length+"&times; "+esc(st)+'</div></div>';
      if(i<names.length-1)html+='<span class="arrow">&#8594;</span>';
    });
    html+="</div>";
    if(m&&m.eps!=null){
      const bp=Math.min(100,Math.round(m.backpressure_pct||0));
      html+='<div class="kv">throughput: <b>'+
        (m.eps>1e6?(m.eps/1e6).toFixed(2)+"M":Math.round(m.eps))+
        ' rec/s</b> &nbsp; records in/out: '+m.records_in+"/"+
        m.records_out+' &nbsp; watermark lag: '+
        Math.round(m.wm_lag_ms||0)+'ms</div>';
      const dp=Math.min(100,Math.round(m.drain_busy_pct||0));
      html+='<div class="kv">backpressure: <span class="gauge">'+
        '<i style="width:'+bp+'%"></i></span> '+bp+
        "% &nbsp; drain link: <span class=\"gauge\">"+
        '<i style="width:'+dp+'%"></i></span> '+dp+"%</div>";
      const rc=g.rescale||{};const rm=rc.metrics||{};
      if(rc.pending_devices!=null){
        html+='<div class="kv">rescale: <b>in flight</b> &#8594; '+
          rc.pending_devices+' dev &times; '+
          (rc.pending_processes||1)+' proc ('+
          (rc.savepoints_collected||0)+' savepoints in)</div>';
      }else if(rm["coordinator.rescale.armed"]){
        html+='<div class="kv">rescale: '+
          rm["coordinator.rescale.armed"]+' armed / '+
          (rm["coordinator.rescale.redeploy"]||0)+' completed / '+
          (rm["coordinator.rescale.disarmed"]||0)+
          ' disarmed &nbsp; time-to-rescale p50: '+
          Math.round(rm["coordinator.rescale.duration_ms.p50"]||0)+
          'ms</div>';
      }
      if(m.checkpoints&&m.checkpoints.length){
        html+="<table><tr><th>checkpoint</th><th>time</th>"+
          "<th>size</th></tr>"+m.checkpoints.map(c=>
          "<tr><td>chk-"+c.id+"</td><td>"+
          new Date(c.ts).toLocaleTimeString()+"</td><td>"+
          fmtB(c.bytes)+"</td></tr>").join("")+"</table>";
      }
    }
  }
  if(!jobs.length)html="<p>no jobs</p>";
  document.getElementById("jobs").innerHTML=html;
  const rs=(await j("/taskmanagers")).taskmanagers||{};
  document.getElementById("runners").innerHTML=
    "<table><tr><th>id</th><th>status</th><th>devices</th></tr>"+
    Object.entries(rs).map(([id,r])=>"<tr><td>"+esc(id)+"</td><td>"+
      (r.alive?"alive":"lost")+"</td><td>"+r.n_devices+
      "</td></tr>").join("")+"</table>";
}
tick();setInterval(tick,2000);
</script></body></html>"""
