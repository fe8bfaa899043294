"""Live-optimize viewer: the HTML map viewer with the reference GUI's
"optimize" interactivity (app/bal_gui.cpp:88-116 runs the solver on a
background thread while the display redraws each iteration).

Headless redesign: instead of a GL window on the machine with the
card, a tiny stdlib HTTP server serves the self-contained viewer page;
pressing "optimize" starts `optimize_lm` on the card (or on the CPU
with `--device cpu`) on a background thread with an iteration callback
(solver/lm.py) that brings the state to the host and snapshots it, and
the page polls /state and hot-swaps the point/frustum buffers. Works
over an SSH port-forward; no external assets, no websockets.

    python -m rootba_tpu_torch.eval.live_view problem.txt --port 8008
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

import numpy as np
import torch

_LIVE_JS = """
let liveIt=-1, polling=false;
function swap(d){
  const np_=unpack(d.points,3), nc=unpack(d.cam_c,3);
  P.a.set(np_.a); CC.a.set(nc.a);
  EX.a.set(unpack(d.cam_ex,3).a); EY.a.set(unpack(d.cam_ey,3).a);
  EZ.a.set(unpack(d.cam_ez,3).a);
  OO.a.set(unpack(d.ov_obs,2).a); OR.a.set(unpack(d.ov_rep,2).a);
  draw(); if(showOv) drawOverlay();
}
async function poll(){
  if(polling) return; polling=true;
  try{
    const r=await fetch('/state?since='+liveIt);
    const d=await r.json();
    if(d.it>liveIt){
      liveIt=d.it;
      document.getElementById('live').textContent=
        ` it ${d.it}`+(d.cost!=null?` cost ${d.cost.toExponential(4)}`:'')+
        (d.done?' (done)':'')+(d.error?` error: ${d.error}`:'');
      if(d.payload) swap(d.payload);
    }
    polling=false;
    if(d.running&&!d.done) setTimeout(poll,500);
  }catch(e){polling=false;}
}
document.getElementById('bopt').onclick=async()=>{
  await fetch('/optimize',{method:'POST'});
  liveIt=-1; setTimeout(poll,300);
};
"""

_LIVE_BTN = ('<button id="bopt">optimize</button>'
             '<span id="live"></span>')


class _LiveState:
    def __init__(self):
        self.lock = threading.Lock()
        self.it = -1
        self.cost = None  # None (not NaN): NaN is invalid JSON and
        #  the browser's strict JSON.parse rejects the whole response
        self.payload = None
        self.running = False
        self.done = False
        self.error = None  # the solve's exception, as text


def _host(t: torch.Tensor) -> np.ndarray:
    """A state tensor as a float64 numpy array on the host: numpy cannot
    read a CUDA tensor, so it is copied to the CPU first."""
    return t.detach().to("cpu", torch.float64).numpy()


def _snapshot(problem, bp, state, max_points):
    """Write the device state back into a host problem copy and build a
    fresh viewer payload."""
    from rootba_tpu_torch.bal.bucketing import scatter_landmarks
    from rootba_tpu_torch.eval.html_view import viewer_payload

    problem.lm_p[:] = scatter_landmarks(bp, [_host(p) for p in state.lm_ps])
    problem.cam_q[:] = _host(state.cams.q)
    problem.cam_t[:] = _host(state.cams.t)
    problem.cam_intr[:] = _host(state.cams.intr)
    return viewer_payload(problem, max_points=max_points)


def make_server(problem, options=None, port: int = 8008,
                max_points: int = 400_000, device: str = "cuda"):
    """The live viewer's HTTP server on 127.0.0.1:`port` (0: a free
    port; read it from `server_address`), not yet serving. The solve
    runs on `device`, resolved here: without a card, "cuda" raises now,
    not in the solve thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from rootba_tpu_torch.config.options import SolverOptions
    from rootba_tpu_torch.eval.html_view import _TEMPLATE, viewer_payload
    from rootba_tpu_torch.utils.device import resolve_device

    dev = resolve_device(str(device))
    if options is None:
        options = SolverOptions(use_double=False, lm_loop="host",
                                verbosity_level=2)
    options.lm_loop = "host"  # the callback needs host-driven iterations

    live = _LiveState()
    html = (_TEMPLATE
            .replace("__DATA__",
                     json.dumps(viewer_payload(problem,
                                               max_points=max_points)))
            .replace("<!--LIVEBTN-->", _LIVE_BTN)
            .replace("__LIVE__", _LIVE_JS))

    def solve_thread():
        from rootba_tpu_torch.bal.bucketing import bucketize
        from rootba_tpu_torch.log.summary import SolverSummary
        from rootba_tpu_torch.solver.lm import optimize_lm

        work = problem.copy()
        bp = bucketize(work, pow2_from=options.bucket_pow2_from)

        def cb(it, state, summary):
            payload = _snapshot(work, bp, state, max_points)
            with live.lock:
                live.it = it
                live.cost = (float(summary.iterations[-1]
                                   .cost.all.error)
                             if summary.iterations else None)
                live.payload = payload

        try:
            optimize_lm(bp, options, SolverSummary(), device=dev,
                        iteration_callback=cb)
        except Exception as e:
            with live.lock:
                live.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            with live.lock:
                live.running = False
                live.done = True

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/state"):
                since = -1
                if "since=" in self.path:
                    try:
                        since = int(self.path.split("since=")[1]
                                    .split("&")[0])
                    except ValueError:
                        pass
                with live.lock:
                    out = {"it": live.it, "cost": live.cost,
                           "running": live.running, "done": live.done,
                           "error": live.error}
                    if live.it > since and live.payload is not None:
                        out["payload"] = live.payload
                self._json(out)
                return
            body = html.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path == "/optimize":
                with live.lock:
                    if live.running:
                        self._json({"status": "already running"})
                        return
                    live.running = True
                    live.done = False
                    live.it = -1
                    live.error = None
                threading.Thread(target=solve_thread,
                                 daemon=True).start()
                self._json({"status": "started"})
                return
            self._json({"error": "unknown endpoint"}, 404)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve(problem, options=None, port: int = 8008,
          max_points: int = 400_000, device: str = "cuda") -> None:
    """Serve the live viewer until interrupted; the solve runs on
    `device`."""
    srv = make_server(problem, options, port, max_points, device)
    port = srv.server_address[1]
    print(f"live viewer at http://127.0.0.1:{port}/ "
          f"(optimize button runs the solver; ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="live-optimize map viewer")
    ap.add_argument("input", help="problem file (.npz / BAL text)")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--max-points", type=int, default=400_000)
    ap.add_argument("--max-num-iterations", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on: 'cuda' (default; "
                         "raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
    from rootba_tpu_torch.config.options import (
        BalDatasetOptions,
        SolverOptions,
    )
    from rootba_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # before the load and the server
    problem = load_normalized_bal_problem(
        BalDatasetOptions(input=args.input, quiet=True))
    opts = SolverOptions(use_double=False, lm_loop="host",
                         verbosity_level=2,
                         max_num_iterations=args.max_num_iterations)
    serve(problem, opts, port=args.port, max_points=args.max_points,
          device=str(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
